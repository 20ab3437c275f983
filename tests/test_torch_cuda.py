"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Marked ``cuda``: they skip without a card. Imports neither JAX
nor the JAX package, so the card's machine runs them without
tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the forwards (RoIPoolF, RoILoopPool) bitwise (max pooling
selects an element, it rounds nothing), and so is RoIPoolF's first-max
index; RoIAlign bitwise too (the kernel
spells every float operation of the plain version in its order, with
round-to-nearest intrinsics, so nothing is contracted into an FMA; NaN in
the same places on a map with non-finite cells); the backward (the scatter
from the saved index) bitwise with
integer cotangents (small integers sum exactly in float32 in any order, so
this checks the routing) and within
1e-5 |x| + 1e-6 sum|g| per cell with normal cotangents (both sides add
with float atomics, in an order that changes from run to run; the sum of
the magnitudes bounds every partial sum).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nafwebsod_torch.ops import context as ctx
from nafwebsod_torch.ops import roi_pool as rp

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda')


def _rois(rng, r, im_w, im_h):
    """Log-uniform boxes from 8 px to the image, coordinates whose x/8 is
    exactly .5, degenerate boxes and boxes past the map's edge."""
    x1 = rng.uniform(0, im_w - 8, r)
    y1 = rng.uniform(0, im_h - 8, r)
    bw = np.exp(rng.uniform(np.log(8), np.log(im_w), r))
    bh = np.exp(rng.uniform(np.log(8), np.log(im_h), r))
    rois = np.stack([np.zeros(r), x1, y1, x1 + bw, y1 + bh], 1)
    n = r // 8
    rois[:n, 1:] = rng.randint(0, min(im_w, im_h) // 8, (n, 4)) * 8 + 4.0
    rois[n:2 * n, 3:5] = rois[n:2 * n, 1:3] - rng.uniform(1, 60, (n, 2))
    rois[2 * n:3 * n, 3:5] += rng.uniform(50, 400, (n, 2))
    return rois.astype(np.float32)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('h,w,c,r', [(87, 119, 512, 2048),
                                     (13, 9, 200, 64), (5, 6, 1, 7)])
def test_roi_pool_kernel_matches_plain_version(card, dtype, h, w, c, r):
    rng = np.random.RandomState(h * w + c)
    feat = torch.from_numpy(rng.randn(h, w, c).astype(np.float32))
    feat = feat.to(card, dtype)
    rois = torch.from_numpy(_rois(rng, r, 8 * w, 8 * h)).to(card)
    before = rp.roi_pool_cuda.launches
    got = rp.roi_pool(feat, rois)
    assert rp.roi_pool_cuda.launches == before + 1
    want = rp.roi_pool_reference(feat, rois)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (r, 7, 7, c)
    assert torch.equal(got, want)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('c', [3, 20, 64, 512, 520])
def test_roi_pool_kernel_and_index_at_any_channel_count(card, dtype, c):
    """C in {3, 20, 64, 512, 520}: 16-byte loads where C allows them,
    narrower ones otherwise; the pooled map and the first-max index both
    bitwise the plain versions', on a ReLU map (tied zeros)."""
    rng = np.random.RandomState(c)
    feat = torch.relu(torch.from_numpy(
        rng.randn(30, 41, c).astype(np.float32))).to(card, dtype)
    rois = torch.from_numpy(_rois(rng, 300, 8 * 41, 8 * 30)).to(card)
    per_load = 16 // feat.element_size()
    while c % per_load:
        per_load //= 2
    assert rp.channels_per_load(feat) == per_load
    got, index = rp.roi_pool_cuda(feat, rois, argmax=True)
    torch.cuda.synchronize()
    assert torch.equal(got, rp.roi_pool_reference(feat, rois))
    assert index.dtype == torch.int32
    assert torch.equal(index, rp.roi_pool_argmax_reference(feat, rois))
    assert torch.equal(rp.roi_pool_cuda(feat, rois), got)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_roi_pool_kernel_on_a_map_whose_base_is_not_16_byte_aligned(card,
                                                                     dtype):
    """An offset view of a larger buffer: the wrapper takes narrower loads
    inside the kernel (channels_per_load says how many) and the result is
    the plain version's."""
    rng = np.random.RandomState(1)
    size = 30 * 41 * 64
    buf = torch.from_numpy(rng.randn(size + 1).astype(np.float32)).to(
        card, dtype)
    feat = buf[1:].view(30, 41, 64)
    assert feat.data_ptr() % 16 != 0
    assert rp.channels_per_load(feat) == 1
    rois = torch.from_numpy(_rois(rng, 200, 8 * 41, 8 * 30)).to(card)
    got, index = rp.roi_pool_cuda(feat, rois, argmax=True)
    assert torch.equal(got, rp.roi_pool_reference(feat, rois))
    assert torch.equal(index, rp.roi_pool_argmax_reference(feat, rois))


def test_roi_pool_kernel_maps_nan_bins_to_zero(card):
    feat = torch.ones(8, 8, 4, device=card)
    feat[2, 3, 1] = float('nan')
    feat[5, 5, 2] = float('inf')
    rois = torch.tensor([[0, 0, 0, 63, 63]], dtype=torch.float32,
                        device=card)
    got, index = rp.roi_pool_cuda(feat, rois, argmax=True)
    assert torch.equal(got, rp.roi_pool_reference(feat, rois))
    assert torch.equal(index, rp.roi_pool_argmax_reference(feat, rois))
    # the bins that hold the NaN or the inf, and only those, get no index
    assert (index[..., 0] >= 0).all() and (index[..., 3] >= 0).all()
    assert (index[..., 1] == -1).any() and (index[..., 2] == -1).any()


def test_roi_pool_kernel_rejects_what_it_does_not_take(card):
    rois = torch.zeros(3, 5, device=card)
    with pytest.raises(ValueError):
        rp.roi_pool_cuda(torch.zeros(4, 4, 8, device=card,
                                     dtype=torch.float16), rois)
    with pytest.raises(ValueError):
        rp.roi_pool_cuda(torch.zeros(4, 8, 4, device=card).transpose(1, 2),
                         rois)
    with pytest.raises(ValueError):
        rp.roi_pool_cuda(torch.zeros(4, 4, 8, device=card), rois.double())
    assert rp.roi_pool_cuda(torch.zeros(4, 4, 8, device=card),
                            rois[:0]).shape == (0, 7, 7, 8)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('h,w,c,r,g', [(87, 119, 512, 2048, 1),
                                       (87, 119, 512, 2048, 3),
                                       (30, 40, 128, 256, 3),
                                       (13, 9, 200, 64, 2), (5, 6, 1, 7, 1)])
def test_roi_pool_backward_kernel_matches_plain_version(card, dtype, h, w, c,
                                                        r, g):
    rng = np.random.RandomState(h * w + c)
    # ReLU features: the tied zeros must all go to the first cell
    feat = torch.relu(torch.from_numpy(
        rng.randn(h, w, c).astype(np.float32))).to(card, dtype)
    rois = torch.from_numpy(_rois(rng, r, 8 * w, 8 * h)).to(card)
    _, index = rp.roi_pool_cuda(feat, rois, argmax=True)
    ints = torch.from_numpy(rng.randint(-3, 4, (g, r, 7, 7, c)).astype(
        np.float32)).to(card, dtype)
    before = rp.roi_pool_backward_cuda.launches
    got = rp.roi_pool_backward(index, ints, h, w)
    assert rp.roi_pool_backward_cuda.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (g, h, w, c)
    assert torch.equal(got, rp.roi_pool_scatter_reference(index, ints, h, w))
    assert torch.equal(got, rp.roi_pool_backward_reference(feat, rois, ints))
    normal = torch.from_numpy(rng.randn(g, r, 7, 7, c).astype(
        np.float32)).to(card, dtype)
    got = rp.roi_pool_backward_cuda(index, normal, h, w)
    want = rp.roi_pool_backward_reference(feat, rois, normal)
    mass = rp.roi_pool_backward_reference(feat, rois, normal.abs())
    assert not ((got - want).abs() > 1e-5 * want.abs() + 1e-6 * mass).any()
    assert not rp.roi_pool_backward_cuda(
        index, torch.zeros_like(normal), h, w).any()


def test_roi_pool_backward_kernel_on_unaligned_cotangents(card):
    """Cotangents whose base is not 16-byte aligned take the kernel's
    one-element path: the same routing."""
    rng = np.random.RandomState(2)
    feat = torch.relu(torch.from_numpy(
        rng.randn(30, 40, 64).astype(np.float32))).to(card)
    rois = torch.from_numpy(_rois(rng, 100, 320, 240)).to(card)
    _, index = rp.roi_pool_cuda(feat, rois, argmax=True)
    buf = torch.from_numpy(rng.randint(-3, 4, 100 * 49 * 64 + 1).astype(
        np.float32)).to(card)
    g = buf[1:].view(1, 100, 7, 7, 64)
    assert g.data_ptr() % 16 != 0
    got = rp.roi_pool_backward_cuda(index, g, 30, 40)
    assert torch.equal(got, rp.roi_pool_scatter_reference(index, g, 30, 40))


def test_roi_pool_autograd_function_launches_both_kernels(card):
    rng = np.random.RandomState(0)
    feat = torch.relu(torch.from_numpy(
        rng.randn(20, 24, 64).astype(np.float32))).to(card)
    rois = torch.from_numpy(_rois(rng, 32, 192, 160)).to(card)
    g = torch.from_numpy(rng.randint(-2, 3, (32, 7, 7, 64)).astype(
        np.float32)).to(card)
    leaf = feat.clone().requires_grad_(True)
    fwd, bwd = rp.roi_pool_cuda.launches, rp.roi_pool_backward_cuda.launches
    with_index = rp.roi_pool_cuda.argmax_launches
    out = rp.roi_pool(leaf, rois)
    out.backward(g)
    assert rp.roi_pool_cuda.launches == fwd + 1
    assert rp.roi_pool_cuda.argmax_launches == with_index + 1
    assert rp.roi_pool_backward_cuda.launches == bwd + 1
    assert torch.equal(out.detach(), rp.roi_pool_reference(feat, rois))
    want = rp.roi_pool_backward_reference(feat, rois, g[None])[0]
    assert torch.equal(leaf.grad, want)
    # a map that needs no gradient: the forward writes no index
    rp.roi_pool(feat, rois)
    assert rp.roi_pool_cuda.argmax_launches == with_index + 1


def test_roi_pool_backward_kernel_skips_nan_and_inf_bins(card):
    feat = torch.ones(8, 8, 4, device=card)
    feat[2, 3, 1] = float('nan')
    feat[5, 5, 2] = float('inf')
    rois = torch.tensor([[0, 0, 0, 63, 63]], dtype=torch.float32,
                        device=card)
    g = torch.ones(1, 1, 7, 7, 4, device=card)
    _, index = rp.roi_pool_cuda(feat, rois, argmax=True)
    got = rp.roi_pool_backward_cuda(index, g, 8, 8)
    assert torch.equal(got, rp.roi_pool_backward_reference(feat, rois, g))
    assert got[..., 0].sum() == 49


def test_roi_pool_backward_kernel_rejects_what_it_does_not_take(card):
    index = torch.zeros(3, 7, 7, 8, dtype=torch.int32, device=card)
    g = torch.zeros(1, 3, 7, 7, 8, device=card)
    with pytest.raises(ValueError):
        rp.roi_pool_backward_cuda(index, g.half(), 4, 4)
    with pytest.raises(ValueError):
        rp.roi_pool_backward_cuda(index.long(), g, 4, 4)
    with pytest.raises(ValueError):
        rp.roi_pool_backward_cuda(index, g[0], 4, 4)
    with pytest.raises(ValueError):
        rp.roi_pool_backward_cuda(index, g.transpose(2, 3), 4, 4)
    with pytest.raises(ValueError):
        rp.roi_pool_backward_cuda(index, g.cpu(), 4, 4)
    assert rp.roi_pool_backward_cuda(index[:0], g[:, :0], 4, 4).shape == (
        1, 4, 4, 8)


def _first_max_pool_backward(x, g, stride):
    """The cotangent of each 2x2 window to its first max in row-major
    window order, written out for an (N, C, H, W) input."""
    n, c, h, w = x.shape
    oh, ow = g.shape[2:]
    dx = torch.zeros_like(x)
    taken = torch.zeros(g.shape, dtype=torch.bool, device=x.device)
    y = F.max_pool2d(x, 2, stride)
    for dy_, dx_ in ((0, 0), (0, 1), (1, 0), (1, 1)):
        view = x[:, :, dy_:dy_ + stride * oh:stride,
                 dx_:dx_ + stride * ow:stride]
        hit = (view == y) & ~taken
        taken |= hit
        dx[:, :, dy_:dy_ + stride * oh:stride,
           dx_:dx_ + stride * ow:stride] += torch.where(
               hit, g, torch.zeros_like(g))
    return dx


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('stride', [2, 1])
def test_max_pool_backward_routes_to_the_first_max_on_the_card(card, stride,
                                                               dtype):
    rng = np.random.RandomState(stride)
    x = torch.from_numpy(np.maximum(rng.randint(-4, 3, (1, 64, 45, 59)), 0)
                         .astype(np.float32)).to(card, dtype)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    out = F.max_pool2d(x, 2, stride)
    g = torch.from_numpy(rng.randint(-3, 4, tuple(out.shape)).astype(
        np.float32)).to(card, dtype)
    out.backward(g)
    want = _first_max_pool_backward(x.detach(), g, stride)
    assert torch.equal(x.grad, want)


# (batch, outer box, inner box) rows a proposal never gives roi_context.
RING_EDGE_ROIS = [
    [0, 16, 16, 170, 170, 16, 16, 170, 170],    # inner box == outer box
    [0, 16, 16, 170, 170, 80, 80, 80, 80],      # a one-cell inner box
    [0, 16, 16, 170, 170, 80, 80, 88, 88],      # two cells wide: no interior
    [0, 16, 16, 170, 170, 40, 40, 120, 120],    # a proper ring
    [0, 0, 0, 184, 184, 0, 0, 184, 184],        # only the border cells
    [0, 150, 150, 700, 900, 200, 200, 600, 800],    # outer box past the map
    [0, 4000, 4000, 5000, 5000, 4200, 4200, 4800, 4800],    # off the map
    [0, 100, 100, 60, 60, 90, 90, 70, 70],      # inverted: extents floor at 1
    [0, 0, 0, 0, 0, 0, 0, 0, 0],                # a padded row
]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('stream', ['frame', 'context'])
@pytest.mark.parametrize('kind', ['relu', 'signed', 'negative', 'non_finite'])
@pytest.mark.parametrize('h,w,c,r', [(87, 119, 512, 2048),
                                     (24, 24, 200, 64), (5, 6, 1, 7)])
def test_roi_loop_pool_kernel_matches_plain_version(card, dtype, stream, kind,
                                                    h, w, c, r):
    rng = np.random.RandomState(h * w + c)
    feat = rng.randn(h, w, c).astype(np.float32)
    if kind == 'relu':
        feat = np.maximum(feat, 0)
    elif kind == 'negative':
        feat = -np.abs(feat) - 1
    elif kind == 'non_finite':
        feat[h // 2, w // 2, 0] = np.nan
        feat[h // 3, w // 3, c // 2] = np.inf
        feat[1, 2, c - 1] = -np.inf
    feat = torch.from_numpy(feat).to(card, dtype)
    proposals = torch.from_numpy(_rois(rng, r, 8 * w, 8 * h)).to(card)
    rois9 = dict(zip(('frame', 'context'), ctx.roi_context(
        proposals, 8 * h, 8 * w, 1.8)))[stream]
    rois9 = torch.cat([rois9, torch.tensor(RING_EDGE_ROIS, device=card)])
    before = ctx.roi_loop_pool_cuda.launches
    got = ctx.roi_loop_pool(feat, rois9.contiguous())
    assert ctx.roi_loop_pool_cuda.launches == before + 1
    want = ctx.roi_loop_pool_reference(feat, rois9)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (rois9.shape[0], 7, 7, c)
    assert torch.equal(got, want)
    assert torch.isfinite(got).all() and (got >= 0).all()
    if kind == 'negative':
        assert not got.any()
    if kind == 'relu':
        assert got.any()


def test_roi_loop_pool_kernel_rejects_what_it_does_not_take(card):
    rois9 = torch.zeros(3, 9, device=card)
    feat = torch.zeros(4, 4, 8, device=card)
    with pytest.raises(ValueError):
        ctx.roi_loop_pool_cuda(feat.half(), rois9)
    with pytest.raises(ValueError):
        ctx.roi_loop_pool_cuda(feat.transpose(0, 1), rois9)
    with pytest.raises(ValueError):
        ctx.roi_loop_pool_cuda(feat, rois9[:, :5].contiguous())
    with pytest.raises(ValueError):
        ctx.roi_loop_pool_cuda(feat, rois9.cpu())
    before = ctx.roi_loop_pool_cuda.launches
    assert ctx.roi_loop_pool_cuda(feat, rois9[:0]).shape == (0, 7, 7, 8)
    assert ctx.roi_loop_pool_cuda.launches == before
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        ctx.roi_loop_pool(feat.clone().requires_grad_(True), rois9)


def test_context_streams_on_the_card_equal_the_plain_versions(card):
    """heads.context_pooled_feats: K1 once and K2 twice, bitwise the plain
    versions' streams; padded all-zero rows give no NaN."""
    from nafwebsod_torch.models import heads
    rng = np.random.RandomState(3)
    feat = torch.relu(torch.from_numpy(
        rng.randn(40, 52, 64).astype(np.float32))).to(card, torch.bfloat16)
    rois = _rois(rng, 96, 400, 310)
    rois[-8:] = 0
    rois = torch.from_numpy(rois).to(card)
    obn = torch.from_numpy(rng.rand(96, 1).astype(np.float32) + 1).to(card)
    k1, k2 = rp.roi_pool_cuda.launches, ctx.roi_loop_pool_cuda.launches
    got = heads.context_pooled_feats(feat, rois, obn, 0.125, 310, 400)
    assert rp.roi_pool_cuda.launches == k1 + 1
    assert ctx.roi_loop_pool_cuda.launches == k2 + 2
    want = heads.context_pooled_feats(feat.cpu(), rois.cpu(), obn.cpu(),
                                      0.125, 310, 400)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.equal(g.cpu(), w)


# RoIAlign edge rows on an (87, 119) map at scale 1/8: samples at exactly
# -1, H and W (14 and 7 bins), boxes past and off the map, a sub-cell box,
# an inverted box, padded rows.
ALIGN_EDGE_ROIS = [
    [0, 800, 600, 1200, 900], [0, -16, 256, 432, 704],
    [0, 512, -16, 960, 432], [0, -16, 480, 208, 704],
    [0, 736, -16, 960, 208], [0, 100.3, 100.7, 101.1, 102.9],
    [0, 400, 300, 200, 100], [0, 2000, 2000, 2100, 2100],
    [0, -500, -500, -100, -100], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('kind', ['signed', 'non_finite'])
@pytest.mark.parametrize('res,sr', [(14, 2), (7, 2), (7, 1), (5, 3)])
@pytest.mark.parametrize('h,w,c,r', [(87, 119, 512, 2048),
                                     (13, 9, 200, 64), (5, 6, 1, 7)])
def test_roi_align_kernel_matches_plain_version(card, dtype, kind, res, sr,
                                                h, w, c, r):
    rng = np.random.RandomState(h * w + c + res)
    feat = torch.from_numpy(rng.randn(h, w, c).astype(np.float32))
    if kind == 'non_finite':
        feat[h // 2, w // 2, 0] = float('nan')
        feat[1, 2, c - 1] = float('inf')
        feat[h - 1, w - 1, c // 2] = float('-inf')
    feat = feat.to(card, dtype)
    rois = torch.cat([
        torch.from_numpy(_rois(rng, r, 8 * w, 8 * h)),
        torch.tensor(ALIGN_EDGE_ROIS, dtype=torch.float32)]).to(card)
    before = rp.roi_align_cuda.launches
    got = rp.roi_align(feat, rois, res, res, 0.125, sr,
                       out_dtype=torch.float32)
    assert rp.roi_align_cuda.launches == before + 1
    want = rp.roi_align_reference(feat, rois, res, res, 0.125, sr)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert got.shape == (r + len(ALIGN_EDGE_ROIS), res, res, c)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])
    assert kind == 'non_finite' or not nan.any()
    # the default output type is the map's: one rounding at the end
    assert torch.equal(rp.roi_align(feat, rois[:9], res, res, 0.125, sr)[
        ~nan[:9]], got[:9].to(dtype)[~nan[:9]])


def test_roi_align_kernel_rejects_what_it_does_not_take(card):
    feat = torch.zeros(8, 8, 4, device=card)
    rois = torch.tensor([[0.0, 0, 0, 30, 30]], device=card)
    assert rp.roi_align(feat, rois[:0]).shape == (0, 7, 7, 4)
    with pytest.raises(ValueError):
        rp.roi_align_cuda(feat.double(), rois)
    with pytest.raises(ValueError):
        rp.roi_align_cuda(feat.permute(1, 0, 2), rois)
    with pytest.raises(ValueError):
        rp.roi_align_cuda(feat, rois.cpu())
    with pytest.raises(ValueError):
        rp.roi_align_cuda(feat, rois[:, :4])
    with pytest.raises(ValueError):
        rp.roi_align_cuda(feat, rois, 7, 7, 0.125, 0)
    with pytest.raises(NotImplementedError):
        rp.roi_align(feat.clone().requires_grad_(True), rois)


def test_mask_head_on_the_card_equals_the_plain_roi_align(card):
    """forward_masks with the kernel and with the plain RoIAlign on the
    same model: identical soft masks."""
    from nafwebsod_torch.models import detector
    model = detector.build_model(detector.ModelSpec(
        num_classes=5, hidden_dim=16, box_head='vgg16_2fc', webly_on=False,
        mask_on=True, mask_dim_reduced=8, compute_dtype='bfloat16'),
        device=card)
    gen = torch.Generator(device=card).manual_seed(0)
    image = torch.randn(1, 96, 128, 3, device=card, generator=gen) * 20
    rois = torch.tensor([[0, 4, 6, 90, 70], [0, 30, 20, 127, 95],
                         [0, 0, 0, 0, 0]], dtype=torch.float32, device=card)
    before = rp.roi_align_cuda.launches
    got = model.forward_masks(image, rois)
    assert rp.roi_align_cuda.launches == before + 1
    kernel = rp.roi_align_cuda
    rp.roi_align_cuda = lambda *a: rp.roi_align_reference(*a)
    try:
        want = model.forward_masks(image, rois)
    finally:
        rp.roi_align_cuda = kernel
    assert got.shape == (3, 28, 28, 5) and torch.equal(got, want)
