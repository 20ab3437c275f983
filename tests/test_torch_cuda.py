"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Marked ``cuda``: they skip without a card. Imports neither JAX
nor the JAX package, so the card's machine runs them without
tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the forwards (RoIPoolF, RoILoopPool) bitwise (max pooling
selects an element, it rounds nothing); the backward bitwise with integer cotangents (small integers sum
exactly in float32 in any order, so this checks the routing) and within
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


def test_roi_pool_kernel_maps_nan_bins_to_zero(card):
    feat = torch.ones(8, 8, 4, device=card)
    feat[2, 3, 1] = float('nan')
    rois = torch.tensor([[0, 0, 0, 63, 63]], dtype=torch.float32,
                        device=card)
    got = rp.roi_pool_cuda(feat, rois)
    assert torch.equal(got, rp.roi_pool_reference(feat, rois))


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
                                       (30, 40, 128, 256, 3),
                                       (13, 9, 200, 64, 2), (5, 6, 1, 7, 1)])
def test_roi_pool_backward_kernel_matches_plain_version(card, dtype, h, w, c,
                                                        r, g):
    rng = np.random.RandomState(h * w + c)
    # ReLU features: the tied zeros must all go to the first cell
    feat = torch.relu(torch.from_numpy(
        rng.randn(h, w, c).astype(np.float32))).to(card, dtype)
    rois = torch.from_numpy(_rois(rng, r, 8 * w, 8 * h)).to(card)
    ints = torch.from_numpy(rng.randint(-3, 4, (g, r, 7, 7, c)).astype(
        np.float32)).to(card, dtype)
    before = rp.roi_pool_backward_cuda.launches
    got = rp.roi_pool_backward(feat, rois, ints)
    assert rp.roi_pool_backward_cuda.launches == before + 1
    want = rp.roi_pool_backward_reference(feat, rois, ints)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (g, h, w, c)
    assert torch.equal(got, want)
    normal = torch.from_numpy(rng.randn(g, r, 7, 7, c).astype(
        np.float32)).to(card, dtype)
    got = rp.roi_pool_backward_cuda(feat, rois, normal)
    want = rp.roi_pool_backward_reference(feat, rois, normal)
    mass = rp.roi_pool_backward_reference(feat, rois, normal.abs())
    assert not ((got - want).abs() > 1e-5 * want.abs() + 1e-6 * mass).any()
    assert not rp.roi_pool_backward_cuda(
        feat, rois, torch.zeros_like(normal)).any()


def test_roi_pool_autograd_function_launches_both_kernels(card):
    rng = np.random.RandomState(0)
    feat = torch.relu(torch.from_numpy(
        rng.randn(20, 24, 64).astype(np.float32))).to(card)
    rois = torch.from_numpy(_rois(rng, 32, 192, 160)).to(card)
    g = torch.from_numpy(rng.randint(-2, 3, (32, 7, 7, 64)).astype(
        np.float32)).to(card)
    leaf = feat.clone().requires_grad_(True)
    fwd, bwd = rp.roi_pool_cuda.launches, rp.roi_pool_backward_cuda.launches
    rp.roi_pool(leaf, rois).backward(g)
    assert rp.roi_pool_cuda.launches == fwd + 1
    assert rp.roi_pool_backward_cuda.launches == bwd + 1
    want = rp.roi_pool_backward_reference(feat, rois, g[None])[0]
    assert torch.equal(leaf.grad, want)


def test_roi_pool_backward_kernel_skips_nan_and_inf_bins(card):
    feat = torch.ones(8, 8, 4, device=card)
    feat[2, 3, 1] = float('nan')
    feat[5, 5, 2] = float('inf')
    rois = torch.tensor([[0, 0, 0, 63, 63]], dtype=torch.float32,
                        device=card)
    g = torch.ones(1, 1, 7, 7, 4, device=card)
    got = rp.roi_pool_backward_cuda(feat, rois, g)
    assert torch.equal(got, rp.roi_pool_backward_reference(feat, rois, g))
    assert got[..., 0].sum() == 49


def test_roi_pool_backward_kernel_rejects_what_it_does_not_take(card):
    feat = torch.zeros(4, 4, 8, device=card)
    rois = torch.zeros(3, 5, device=card)
    g = torch.zeros(1, 3, 7, 7, 8, device=card)
    with pytest.raises(ValueError):
        rp.roi_pool_backward_cuda(feat.half(), rois, g)
    with pytest.raises(ValueError):
        rp.roi_pool_backward_cuda(feat, rois, g[0])
    with pytest.raises(ValueError):
        rp.roi_pool_backward_cuda(feat, rois, g.transpose(2, 3))
    with pytest.raises(ValueError):
        rp.roi_pool_backward_cuda(feat, rois, g.cpu())
    assert rp.roi_pool_backward_cuda(feat, rois[:0], g[:, :0]).shape == (
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
