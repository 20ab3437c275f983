"""The port's context family (ops/context.py, the three-stream head, the
context branches of the detector, ``im_hw`` end to end) against the JAX
package on the CPU: seeded numpy inputs, bridged ``PRNGKey`` weights,
dropout off.

Tolerances: ``roi_context`` and the ring pool bitwise (the same float32
operations in the same order; a max is exact in float32 and bfloat16);
forward_test scores at rtol 1e-4, atol 1e-5 in float32 (the bound of
tests/test_torch_model.py) and at rtol 8e-2, atol 3e-3 in bfloat16 (that
file's atol, plus a relative term: the detection logit is the difference of
two bfloat16 towers' outputs, the cancellation magnifies the two frameworks'
different rounding places, and the softmax over RoIs turns a logit's
absolute error into a score's relative one); forward_train's total and aux
at rtol 1e-4, atol 1e-5, head gradients at rtol 1e-3, atol 1e-5 of each
leaf's largest entry or of 1 (float32 sums over the RoIs in an order that
depends on the machine's GEMM kernels; fc6 and fc7 sum three uses of the
one tower in another order than XLA does), three chained steps at rtol 1e-3, atol 1e-6 on
the parameters (the bounds of tests/test_torch_train.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafwebsod_tpu.core import config as jax_config
from nafwebsod_tpu.engine import test as jax_infer
from nafwebsod_tpu.models import detector as jax_detector
from nafwebsod_tpu.ops.context import roi_context as jax_roi_context
from nafwebsod_tpu.ops.context import roi_loop_pool_xla
from nafwebsod_tpu.ops.pallas.roi_loop_pool_pallas import roi_loop_pool_pallas
from nafwebsod_tpu.parallel import train_step as jax_ts
from nafwebsod_tpu.solver import sgd as jax_sgd
from nafwebsod_tpu.utils import checkpoint as jax_ckpt
from nafwebsod_torch.core import config as port_config
from nafwebsod_torch.engine import test as infer
from nafwebsod_torch.engine import train as train_engine
from nafwebsod_torch.models import detector, heads
from nafwebsod_torch.ops import context as ctx
from nafwebsod_torch.parallel import train_step as ts
from nafwebsod_torch.utils import checkpoint
from nafwebsod_torch.utils.bridge import (blob_names, named_blobs,
                                          params_from_jax,
                                          state_to_jax_names)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DTYPES = {'float32': jnp.float32, 'bfloat16': jnp.bfloat16}
TORCH_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


@pytest.fixture(autouse=True)
def _fresh_cfgs():
    jax_config.reset_cfg()
    port_config.reset_cfg()
    yield
    jax_config.reset_cfg()
    port_config.reset_cfg()


def _rois(rng, r, span):
    """The proposals of tests/test_pallas_interpret.py: 8 px to the whole
    image, clipped to it."""
    x1 = rng.uniform(-10, span - 50, r)
    y1 = rng.uniform(-10, span - 50, r)
    rois = np.stack([np.zeros(r), x1, y1,
                     x1 + rng.choice([8, 60, 250, span], r),
                     y1 + rng.choice([8, 60, 250, span], r)], 1)
    return np.clip(rois, 0, span - 1).astype(np.float32)


# --------------------------------------------------------------------------- #
# roi_context
# --------------------------------------------------------------------------- #

def _half_boxes(rng, n, span):
    """Boxes whose coordinates, and whose shrunk / grown coordinates where
    float32 allows, land on x / 8 = k + .5: the side of .5 decides the cell
    the ring pool rounds to."""
    xy = rng.randint(0, span // 8 - 10, (n, 2)) * 8 + 4.0
    wh = rng.randint(1, 9, (n, 2)) * 9.0       # w / 1.8 and w * 1.8 / 2 exact
    return np.concatenate([np.zeros((n, 1)), xy, xy + wh],
                          1).astype(np.float32)


@pytest.mark.parametrize('bounds', ['numbers', 'tensors'])
@pytest.mark.parametrize('ratio', [1.8, 2.0])
def test_roi_context_is_bitwise_the_jax_packages(bounds, ratio):
    rng = np.random.RandomState(0)
    rois = np.vstack([_rois(rng, 200, 700), _half_boxes(rng, 56, 700),
                      np.zeros((4, 5), np.float32)])      # padded rows
    im_h, im_w = 688, 917
    want_f, want_c = jax_roi_context(jnp.asarray(rois), im_h, im_w, ratio)
    if bounds == 'tensors':
        im_h, im_w = torch.tensor(688.0), torch.tensor(917.0)
    frame, context = ctx.roi_context(torch.from_numpy(rois), im_h, im_w,
                                     ratio)
    assert frame.dtype == context.dtype == torch.float32
    np.testing.assert_array_equal(frame.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(context.numpy(), np.asarray(want_c))
    # the proposal itself is not clipped; the rings are, to [0, im_w]
    np.testing.assert_array_equal(frame.numpy()[:, 1:5], rois[:, 1:5])
    np.testing.assert_array_equal(context.numpy()[:, 5:9], rois[:, 1:5])
    assert context.numpy()[:, [1, 3]].max() == 917.0
    assert context.numpy()[:, 1:5].min() == 0.0


def test_roi_context_geometry():
    rois = torch.tensor([[0, 10, 20, 50, 60]], dtype=torch.float32)
    frame, context = ctx.roi_context(rois, 100, 100, context_ratio=2.0)
    np.testing.assert_allclose(frame.numpy()[0],
                               [0, 10, 20, 50, 60, 20, 30, 40, 50])
    np.testing.assert_allclose(context.numpy()[0],
                               [0, 0, 0, 70, 80, 10, 20, 50, 60])


# --------------------------------------------------------------------------- #
# roi_loop_pool
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('stream', ['frame', 'context'])
@pytest.mark.parametrize('seed,size,r,span', [(1, 40, 16, 320),
                                              (3, 96, 24, 760)])
def test_reference_equals_xla_and_the_interpreted_kernel(seed, size, r, span,
                                                         stream, dtype):
    """The fixtures of tests/test_pallas_interpret.py."""
    rng = np.random.RandomState(seed)
    feat = rng.randn(size, size, 8).astype(np.float32)
    base = _rois(rng, r, span)
    frame, context = ctx.roi_context(torch.from_numpy(base), span, span, 1.8)
    rois9 = frame if stream == 'frame' else context
    jfeat = jnp.asarray(feat).astype(JAX_DTYPES[dtype])
    jrois = jnp.asarray(rois9.numpy())
    want = np.asarray(roi_loop_pool_xla(jfeat, jrois, 7, 7, 0.125)
                      .astype(jnp.float32))
    kernel = np.asarray(roi_loop_pool_pallas(jfeat, jrois, 7, 7, 0.125,
                                             interpret=True)
                        .astype(jnp.float32))
    got = ctx.roi_loop_pool(torch.from_numpy(feat).to(TORCH_DTYPES[dtype]),
                            rois9)
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (r, 7, 7, 8)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(got.float().numpy(), kernel)
    assert (got >= 0).all() and (got > 0).any()


def _np_loop_pool(feat, roi9, pooled, scale):
    """RoILoopPool cell by cell: half-away rounding, integer bins, the
    running max started at 0, a ring with a non-finite cell mapped to 0."""
    h, w, c = feat.shape
    v = np.asarray(roi9[1:], np.float32) * np.float32(scale)
    q = (np.sign(v) * np.floor(np.abs(v) + np.float32(0.5))).astype(int)
    x1, y1, x2, y2, ix1, iy1, ix2, iy2 = q
    roi_h = max(y2 - y1 + 1, 1)
    roi_w = max(x2 - x1 + 1, 1)
    out = np.zeros((pooled, pooled, c), np.float32)
    for ph in range(pooled):
        hs = min(max((ph * roi_h) // pooled + y1, 0), h)
        he = min(max(-((-(ph + 1) * roi_h) // pooled) + y1, 0), h)
        for pw in range(pooled):
            ws = min(max((pw * roi_w) // pooled + x1, 0), w)
            we = min(max(-((-(pw + 1) * roi_w) // pooled) + x1, 0), w)
            ring = [feat[y, x] for y in range(hs, he) for x in range(ws, we)
                    if not (iy1 < y < iy2 and ix1 < x < ix2)]
            if ring:
                m = np.max(np.stack(ring), axis=0)    # NaN propagates
                out[ph, pw] = np.where(np.isfinite(m), np.maximum(m, 0), 0)
    return out


def test_reference_matches_the_numpy_golden():
    """The rings of tests/test_context.py::TestRoILoopPool."""
    rng = np.random.RandomState(0)
    feat = rng.rand(24, 24, 3).astype(np.float32)
    rois = np.array([
        [0, 8, 8, 120, 120, 40, 40, 90, 90],
        [0, 0, 0, 60, 60, 10, 10, 50, 50],
        [0, 16, 16, 170, 170, 16, 16, 170, 170],
    ], np.float32)
    got = ctx.roi_loop_pool(torch.from_numpy(feat), torch.from_numpy(rois),
                            4, 4, 0.125).numpy()
    for i, roi in enumerate(rois):
        np.testing.assert_array_equal(got[i],
                                      _np_loop_pool(feat, roi, 4, 0.125))


# Edge rows (also held on the card by chip_smoke.py and test_torch_cuda.py).
EDGE_ROIS = np.array([
    [0, 16, 16, 170, 170, 16, 16, 170, 170],    # inner box == outer box
    [0, 16, 16, 170, 170, 80, 80, 80, 80],      # a one-cell inner box
    [0, 16, 16, 170, 170, 80, 80, 88, 88],      # two cells wide: no interior
    [0, 16, 16, 170, 170, 40, 40, 120, 120],    # a proper ring
    [0, 150, 120, 191, 191, 150, 120, 191, 191],  # ring clipped at the edge
    [0, 0, 0, 184, 184, 0, 0, 184, 184],        # the whole map, border only
    [0, 150, 150, 700, 900, 200, 200, 600, 800],  # outer box past the map
    [0, 400, 400, 500, 500, 420, 420, 480, 480],  # wholly off the map
    [0, 100, 100, 60, 60, 90, 90, 70, 70],      # inverted: extents floor at 1
    [0, 0, 0, 0, 0, 0, 0, 0, 0],                # a padded row
], np.float32)


@pytest.mark.parametrize('feat_kind', ['relu', 'signed', 'negative',
                                       'non_finite'])
def test_reference_on_the_edge_rows(feat_kind):
    rng = np.random.RandomState(2)
    feat = rng.randn(24, 24, 4).astype(np.float32)
    if feat_kind == 'relu':
        feat = np.maximum(feat, 0)
    elif feat_kind == 'negative':
        feat = -np.abs(feat) - 1
    elif feat_kind == 'non_finite':
        feat[5, 5, 0] = np.nan          # on rings 0-3: those bins give 0
        feat[10, 10, 1] = np.inf        # inside ring 3's hole: never read
        feat[3, 20, 2] = -np.inf        # loses against the 0 floor
    got = ctx.roi_loop_pool(torch.from_numpy(feat),
                            torch.from_numpy(EDGE_ROIS)).numpy()
    assert np.isfinite(got).all() and (got >= 0).all()
    for i, roi in enumerate(EDGE_ROIS):
        np.testing.assert_array_equal(
            got[i], _np_loop_pool(feat, roi, 7, 0.125), err_msg=str(i))
    if feat_kind == 'negative':
        assert not got.any()
    if feat_kind == 'non_finite':
        hole = ctx.roi_loop_pool(torch.from_numpy(feat[..., 1:2].copy()),
                                 torch.from_numpy(EDGE_ROIS[3:4]))
        assert torch.isfinite(hole).all() and hole.max() < 10
        assert not got[0, :, :, 0].all()      # the NaN's bin is 0
    assert not got[7].any() and got[9].shape == (7, 7, 4)
    # the whole-map ring with the whole map as its hole keeps the border
    if feat_kind == 'relu':
        border = np.ones((24, 24), bool)
        border[1:23, 1:23] = False
        assert got[5].max() == feat[border].max()


def test_reference_keeps_the_exact_bins_past_the_image():
    """``roi_loop_pool_xla`` gathers windows of ceil(H / PH) + 2 rows, which
    holds for outer boxes clipped to the image (the context RoIs, and
    frames of clipped proposals: there all three agree bitwise, see above).
    An outer box far past the map has taller bins and loses cells there;
    the port keeps the exact definition."""
    rng = np.random.RandomState(4)
    feat = np.maximum(rng.randn(24, 24, 4), 0).astype(np.float32)
    roi = np.array([[0, 0, 0, 900, 900, 8, 8, 16, 16]], np.float32)
    got = ctx.roi_loop_pool(torch.from_numpy(feat),
                            torch.from_numpy(roi)).numpy()
    np.testing.assert_array_equal(got[0],
                                  _np_loop_pool(feat, roi[0], 7, 0.125))
    capped = np.asarray(roi_loop_pool_xla(jnp.asarray(feat),
                                          jnp.asarray(roi), 7, 7, 0.125))
    assert (capped <= got).all() and (capped < got).any()


def test_roi_loop_pool_has_no_gradient_and_no_other_device():
    feat = torch.zeros(8, 8, 2, requires_grad=True)
    rois = torch.tensor([[0, 0, 0, 40, 40, 8, 8, 24, 24]],
                        dtype=torch.float32)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        ctx.roi_loop_pool(feat, rois)
    with torch.no_grad():
        assert ctx.roi_loop_pool(feat, rois).shape == (1, 7, 7, 2)
    with pytest.raises(ValueError):
        ctx.roi_loop_pool(torch.zeros(8, 8, 2, device='meta'), rois)
    with pytest.raises(ValueError):
        ctx.roi_loop_pool_cuda(torch.zeros(8, 8, 2), rois)
    assert ctx.roi_loop_pool(torch.zeros(8, 8, 2),
                             rois[:0]).shape == (0, 7, 7, 2)


# --------------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------------- #

KW = dict(num_classes=5, hidden_dim=16, box_head='vgg16_context_2fc',
          webly_on=False, webly_entropy=False)


def _fixture(dtype='float32', seed=0, r=12, padded=3):
    """(jax spec, jax params as numpy, port model, numpy batch): a 48x56
    image on a 64x64 canvas, proposals that touch its edges, padded rows."""
    spec = jax_detector.ModelSpec(compute_dtype=dtype, **KW)
    params = {k: np.asarray(v) for k, v in jax_detector.init_params(
        spec, jax.random.PRNGKey(seed)).items()}
    model = detector.build_model(
        detector.ModelSpec(compute_dtype=dtype, **KW), device='cpu')
    model.load_state_dict(params_from_jax(params))
    rng = np.random.RandomState(seed)
    h, w = 48, 56
    canvas = np.zeros((1, 64, 64, 3), np.float32)
    canvas[:, :h, :w] = rng.randn(1, h, w, 3) * 8
    x1 = rng.uniform(0, w - 16, r)
    y1 = rng.uniform(0, h - 16, r)
    rois = np.stack([np.zeros(r), x1, y1,
                     np.minimum(x1 + rng.uniform(8, 30, r), w - 1),
                     np.minimum(y1 + rng.uniform(8, 30, r), h - 1)],
                    1).astype(np.float32)
    rois[0, 1:] = [30, 20, w - 1, 44]
    rois[1, 1:] = [8, 28, 30, h - 1]
    valid = np.arange(r) < r - padded
    rois[~valid] = 0
    obn = rng.uniform(0.5, 1.5, (r, 1)).astype(np.float32)
    obn[~valid] = 0
    labels = np.zeros((1, 4), np.float32)
    labels[0, [1, 3]] = 1
    batch = {'image': canvas, 'rois': rois, 'obn_scores': obn,
             'labels_oh': labels, 'valid_mask': valid,
             'im_hw': np.array([h, w], np.float32)}
    return spec, params, model, batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_context_model_has_the_reference_blobs():
    spec, params, model, _ = _fixture()
    names = blob_names(model)
    assert set(names) == set(model.state_dict())
    assert set(names.values()) == set(params)
    assert 'fc8d_frame_w' in params and 'fc8d_w' not in params
    assert not hasattr(model.head, 'fc8d') and model.head.noisy is None
    assert 'head.fc8d_frame.weight' not in blob_names()


@pytest.mark.parametrize('dtype,tol', [
    ('float32', dict(rtol=1e-4, atol=1e-5)),
    ('bfloat16', dict(rtol=8e-2, atol=3e-3))])
def test_context_forward_test_matches_jax(dtype, tol):
    spec, params, model, batch = _fixture(dtype)
    jb, pb = _jax(batch), _port(batch)
    want = jax_detector.forward_test(
        spec, {k: jnp.asarray(v) for k, v in params.items()}, jb['image'],
        jb['rois'], jb['obn_scores'], jb['valid_mask'], im_hw=jb['im_hw'])
    out = model.forward_test(pb['image'], pb['rois'], pb['obn_scores'],
                             pb['valid_mask'], im_hw=pb['im_hw'])
    scores = out['scores'].numpy()
    assert scores.shape == (12, 5) and scores.dtype == np.float32
    assert np.isfinite(scores).all()
    np.testing.assert_allclose(scores, np.asarray(want['scores']), **tol)
    np.testing.assert_array_equal(scores[:, 0], scores[:, 1])
    assert not scores[~batch['valid_mask']].any()     # padded rows score 0


def test_context_streams_match_jax_bitwise():
    """The three pooled streams on one map: K1's and K2's plain versions,
    the boost and the C*H*W flatten."""
    from nafwebsod_tpu.models import heads as jax_heads
    rng = np.random.RandomState(5)
    feat = np.maximum(rng.randn(1, 40, 40, 8), 0).astype(np.float32)
    rois = _rois(rng, 16, 320)
    obn = (rng.rand(16, 1) + 1).astype(np.float32)
    want = jax_heads.context_pooled_feats(
        jnp.asarray(feat), jnp.asarray(rois), jnp.asarray(obn), 0.125,
        jnp.float32(300), jnp.float32(310))
    got = heads.context_pooled_feats(
        torch.from_numpy(feat[0]), torch.from_numpy(rois),
        torch.from_numpy(obn), 0.125, torch.tensor(300.0), 310)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == (16, 8 * 7 * 7) and not g.requires_grad
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not torch.equal(got[1], got[2])


def test_context_forward_train_total_aux_and_gradients_match_jax():
    spec, params, model, batch = _fixture()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    (want, want_aux), want_grads = jax.value_and_grad(
        lambda p: jax_detector.forward_train(spec, p, _jax(batch), None),
        has_aux=True)(jp)
    total, aux = model.forward_train(_port(batch))
    assert set(aux) == set(want_aux) == {'loss_cls', 'accuracy_cls'}
    np.testing.assert_allclose(total.item(), float(want), rtol=1e-4,
                               atol=1e-5)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(want_aux[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    blobs = named_blobs(model)
    names = [n for n in blobs if not n.startswith('conv')]
    assert 'fc8d_frame_w' in names and 'fc8d_frame_b' in names
    grads = torch.autograd.grad(total, [blobs[n] for n in names])
    got = state_to_jax_names(dict(zip(names, grads)))
    for n in names:
        ref = np.asarray(want_grads[n])
        # float32 sums over the RoIs and the three streams, in an order
        # that depends on the machine's GEMM kernels (and XLA's)
        np.testing.assert_allclose(got[n], ref, rtol=1e-3,
                                   atol=1e-5 * max(np.abs(ref).max(), 1.0),
                                   err_msg=n)
    # fc6 sums three uses; the shared fc8d_frame bias cancels
    assert float(np.abs(got['fc6_w']).max()) > 0
    assert float(np.abs(got['fc8d_frame_w']).max()) > 0
    assert not got['fc8d_frame_b'].any()
    for n in blobs:
        if n.startswith('conv'):
            assert not np.asarray(want_grads[n]).any(), n


def test_fc6_gradient_sums_the_three_streams():
    _, _, model, batch = _fixture()
    pb = _port(batch)
    feat, scale = model.body_forward(pb['image'])
    flats = heads.context_pooled_feats(
        feat[0].contiguous(), pb['rois'], pb['obn_scores'], scale, 48, 56)
    w = model.head.clean.fc6.weight

    def grad(streams):
        fc7s = model.head.context_towers(
            [x if i in streams else torch.zeros_like(x)
             for i, x in enumerate(flats)])
        out = model.head.wsl_context_outputs(fc7s, pb['valid_mask'])
        return torch.autograd.grad(out['rois_pred'][:, 1].max(), w)[0]

    whole = grad({0, 1, 2})
    assert whole.abs().max() > 0
    for i in range(3):      # each stream reaches fc6 through the one tower
        assert not torch.equal(grad({0, 1, 2} - {i}), whole), i


def test_im_hw_changes_the_result_on_a_padded_canvas():
    spec, params, model, batch = _fixture()
    with_hw, _ = model.forward_train(_port(batch))
    no_hw = {k: v for k, v in batch.items() if k != 'im_hw'}
    without, _ = model.forward_train(_port(no_hw))
    assert abs(with_hw.item() - without.item()) > 1e-7
    want, _ = jax_detector.forward_train(
        spec, {k: jnp.asarray(v) for k, v in params.items()}, _jax(no_hw),
        None)
    np.testing.assert_allclose(without.item(), float(want), rtol=1e-4,
                               atol=1e-5)
    # im_hw equal to the canvas is the same as none; other heads ignore it
    canvas_hw = dict(batch, im_hw=np.array([64, 64], np.float32))
    assert model.forward_train(_port(canvas_hw))[0].item() == without.item()
    plain = detector.build_model(detector.ModelSpec(
        num_classes=5, hidden_dim=16, box_head='vgg16_2fc', webly_on=False),
        device='cpu')
    assert (plain.forward_train(_port(batch))[0].item()
            == plain.forward_train(_port(no_hw))[0].item())


def test_dropout_draws_each_stream_its_own_masks():
    _, _, model, _ = _fixture()
    x = torch.ones(6, 512 * 49)
    gen = torch.Generator().manual_seed(3)
    a = model.head.context_towers((x, x, x), True, gen)
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])
    gen.manual_seed(3)
    b = model.head.context_towers((x, x, x), True, gen)
    for s, t in zip(a, b):
        assert torch.equal(s, t)
    gen.manual_seed(3)       # the first stream draws first: the plain tower's
    assert torch.equal(model.head.clean(x, True, gen), a[0])


def test_three_context_train_steps_track_jax():
    spec, params, model, batch = _fixture()
    trainable = jax_detector.trainable_param_names(spec, params)
    hp_j = jax_sgd.SGDHyperParams()
    mults_j = jax_sgd.freeze_mults(
        jax_sgd.param_multipliers(params, trainable))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state_j = jax_sgd.init_state(jp, hp_j)
    stacked = {k: jnp.asarray(v)[None] for k, v in batch.items()}
    stacked['cur_iter'] = jnp.zeros((1,), jnp.float32)

    port_config.cfg.SOLVER.MOMENTUM = 0.9
    hp, mults, state = train_engine.create_solver(model)
    assert {n for n, m in mults.items() if m != (0.0, 0.0)} == trainable
    lr = np.float32(1e-3)
    for step in range(3):
        jp, state_j, want_loss, _ = jax_ts._step_body(
            spec, hp_j, mults_j, 1, jp, state_j, stacked, lr, [None])
        loss, aux = ts.train_step(model, state, _port(batch), lr, None,
                                  hp=hp, mults=mults)
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4,
                                   atol=1e-5, err_msg=str(step))
    got = state_to_jax_names(named_blobs(model))
    for n in params:
        # the gradients' differences (see the test above) reach the
        # parameters times the learning rate, 1e-3
        np.testing.assert_allclose(got[n], np.asarray(jp[n]), rtol=1e-3,
                                   atol=1e-6, err_msg=n)
        if n.startswith('conv'):
            np.testing.assert_array_equal(got[n], params[n])
    for n in ('fc6_w', 'fc7_w', 'fc8c_w', 'fc8d_frame_w'):
        assert (got[n] != params[n]).any(), n


def test_unfrozen_context_body_raises_for_the_ring_gradient():
    model = detector.build_model(
        detector.ModelSpec(freeze_conv_body=False, freeze_at=0, **KW),
        device='cpu')
    _, _, _, batch = _fixture()
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        model.forward_train(_port(batch))


# --------------------------------------------------------------------------- #
# Config, checkpoints, im_hw through the engines
# --------------------------------------------------------------------------- #

def _same(a, b, key=''):
    assert type(a) is type(b), key
    if isinstance(a, dict):
        assert set(a) == set(b), key
        for k in a:
            _same(a[k], b[k], key + '.' + k)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=key)
    else:
        assert a == b, key


def test_context_dict_equals_the_yaml():
    pytest.importorskip('yaml')
    port_config.merge_cfg_from_file(os.path.join(
        REPO, 'configs', 'wsod_families', 'context_V-16-C5.yaml'))
    from_yaml = dict(port_config.cfg)
    port_config.reset_cfg()
    port_config.merge_cfg_from_cfg(port_config.CONTEXT)
    _same(from_yaml, dict(port_config.cfg))


def test_spec_from_context_cfg():
    port_config.merge_cfg_from_cfg(port_config.CONTEXT)
    spec = detector.spec_from_cfg(port_config.cfg)
    assert spec == detector.ModelSpec(
        num_classes=21, box_head='vgg16_context_2fc', webly_on=False,
        webly_entropy=port_config.cfg.WEBLY.ENTROPY, context_ratio=1.8,
        compute_dtype='bfloat16', hidden_dim=4096, max_gt_cpg=20)
    assert spec.is_context and spec.freeze_conv_body
    jax_config.merge_cfg_from_cfg(port_config.CONTEXT)
    want = jax_detector.spec_from_cfg(jax_config.cfg)
    assert (spec.box_head, spec.context_ratio) == (want.box_head,
                                                   want.context_ratio)
    port_config.cfg.WSL.CONTEXT_RATIO = 2.5
    assert detector.spec_from_cfg(port_config.cfg).context_ratio == 2.5
    for key in ('CPG', 'CSC'):
        port_config.cfg.WSL[key] = True
        with pytest.raises(NotImplementedError, match='context head'):
            detector.spec_from_cfg(port_config.cfg)
        port_config.cfg.WSL[key] = False


def test_context_pkl_round_trip_is_bitwise(tmp_path):
    _, params, model, _ = _fixture(seed=2)
    jax_pkl = str(tmp_path / 'jax.pkl')
    jax_ckpt.save_params_to_weights_file(jax_pkl, params)
    fresh = detector.build_model(detector.ModelSpec(**KW), device='cpu',
                                 seed=9)
    assert checkpoint.initialize_from_weights_file(fresh, jax_pkl) == []
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    port_pkl = str(tmp_path / 'port.pkl')
    checkpoint.save_weights_file(port_pkl, fresh)
    a, _ = checkpoint.load_weights_pkl(jax_pkl)
    b, _ = checkpoint.load_weights_pkl(port_pkl)
    assert set(a) == set(b) and 'fc8d_frame_w' in b and 'fc8d_w' not in b
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_inference_passes_the_blobs_extent_as_im_hw():
    """engine/test.py pads the blob to TPU.SIZE_BUCKET_MULTIPLE; the rings
    clip at the blob's own extent, as in the JAX package's im_detect_bbox."""
    for c in (jax_config.cfg, port_config.cfg):
        c.MODEL.NUM_CLASSES = 5
        c.TPU.SIZE_BUCKET_MULTIPLE = 32
        c.TPU.ROI_PAD_MULTIPLE = 16
    spec, params, model, _ = _fixture()
    rng = np.random.RandomState(0)
    im = np.clip(port_config.cfg.PIXEL_MEANS.reshape(1, 1, 3) +
                 rng.randn(60, 80, 3) * 8, 0, 255).astype(np.uint8)
    boxes = rng.uniform(0, 50, (20, 4)).astype(np.float32)
    boxes[:, 2:] = np.minimum(boxes[:, :2] + 6 + rng.uniform(0, 25, (20, 2)),
                              [79, 59])
    boxes[0] = [40, 20, 79, 59]
    obn = rng.rand(20, 1).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want, _, _ = jax_infer.im_detect_bbox(spec, jp, im, 72, 120, boxes=boxes,
                                          obn_scores=obn)
    seen = []
    forward_test = model.forward_test

    def spy(image, rois, obn_scores, valid_mask=None, im_hw=None):
        seen.append((tuple(image.shape[1:3]), tuple(im_hw)))
        return forward_test(image, rois, obn_scores, valid_mask, im_hw)

    model.forward_test = spy
    got, _, _ = infer.im_detect_bbox(model, im, 72, 120, boxes, obn)
    assert seen == [((96, 96), (72, 96))]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_train_batches_carry_im_hw_to_the_model():
    rng = np.random.RandomState(1)
    blobs = {'data': rng.randn(1, 40, 56, 3).astype(np.float32),
             'rois': np.zeros((4, 5), np.float32),
             'obn_scores': np.ones((4, 1), np.float32),
             'labels_oh': np.eye(4, dtype=np.float32)[:1],
             'valid_mask': np.ones(4, bool),
             'im_hw': np.array([40, 56], np.float32)}
    stacked = ts.stack_minibatches([blobs], size_bucket=32)
    want = jax_ts.stack_minibatches([blobs], size_bucket=32)
    np.testing.assert_array_equal(stacked['im_hw'], want['im_hw'])
    assert stacked['image'].shape == (1, 1, 64, 64, 3)
    batch = ts.to_device_batch(stacked, 'cpu', cur_iter=2)
    assert batch['im_hw'].tolist() == [40.0, 56.0]
    assert batch['cur_iter'] == 2.0
