"""The plain RoIPoolF backward of the port
(nafwebsod_torch/ops/roi_pool.py: the first-max index
roi_pool_argmax_reference, the scatter roi_pool_scatter_reference, their
composition roi_pool_backward_reference and the RoIPoolF autograd
function) against the JAX package's TPU kernel run in interpret mode, its
CPU custom call's argmax and saved-argmax scatter, and autodiff of its XLA
pool, on the CPU.

Tolerance: rtol 1e-5, atol 1e-5 (each cell's sum is taken in another
order); the routing itself is exact, and sums of small integers are
bitwise. On tied maps only the interpret-mode kernel is the reference:
autodiff of the XLA pool splits a tie evenly, the kernel and the port give
it all to the first max cell. The index is -1 where no gradient flows: an
empty bin, a bin with a NaN, a bin whose max is +inf and a bin of -inf
cells (the outputs the forward maps to 0).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafwebsod_tpu.ops.pallas.roi_pool_pallas import roi_pool_pallas_bwd
from nafwebsod_tpu.ops import roi_pool as jax_rp
from nafwebsod_tpu.ops.roi_pool import roi_pool_xla
from nafwebsod_torch.ops import roi_pool as rp

# the RoIs of tests/test_pallas_interpret.py (every window tier of the TPU
# kernel), then an empty-bin box, a box past the map and an inverted one
ROIS = np.array([
    [0, 0, 0, 8 * 40 - 1, 8 * 40 - 1],
    [0, 16, 16, 100, 100],
    [0, 8, 8, 300, 130],
    [0, 24, 24, 280, 290],
    [0, 40, 40, 44, 44],
    [0, 300, 300, 420, 500],
    [0, 100, 100, 40, 40],
], np.float32)


def _interpret(feat, rois, g):
    """The TPU kernel in interpret mode over a seed batch (G, R, 7, 7, C)."""
    return np.asarray(jax.vmap(lambda gg: roi_pool_pallas_bwd(
        jnp.asarray(feat), jnp.asarray(rois), gg, 7, 7, 0.125,
        interpret=True))(jnp.asarray(g)))


def _tie_free(rng, h, w, c):
    return rng.permutation(h * w * c).astype(np.float32).reshape(h, w, c)


def _tied(rng, h, w, c):
    """ReLU-like zeros and a few repeated positive levels."""
    return np.maximum(rng.randint(-3, 4, (h, w, c)), 0).astype(np.float32)


@pytest.mark.parametrize('make', [_tie_free, _tied], ids=['tie_free', 'tied'])
def test_plain_backward_matches_the_interpreted_tpu_kernel(make):
    rng = np.random.RandomState(0)
    feat = make(rng, 40, 40, 8)
    g = rng.randn(3, len(ROIS), 7, 7, 8).astype(np.float32)
    want = _interpret(feat, ROIS, g)
    got = rp.roi_pool_backward_reference(
        torch.from_numpy(feat), torch.from_numpy(ROIS), torch.from_numpy(g))
    assert got.shape == (3, 40, 40, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_plain_backward_matches_xla_autodiff_on_a_tie_free_map():
    rng = np.random.RandomState(1)
    feat = _tie_free(rng, 24, 24, 8)
    # RoIs inside the map: roi_pool_xla's window cap assumes clipped RoIs
    rois = np.array([[0, 8, 8, 100, 80], [0, 0, 0, 50, 60],
                     [0, 0, 0, 191, 191], [0, 40, 40, 44, 44]], np.float32)
    g = rng.randn(1, len(rois), 7, 7, 8).astype(np.float32)
    want = jax.grad(lambda f: jnp.sum(roi_pool_xla(
        f, jnp.asarray(rois), 7, 7, 0.125) * jnp.asarray(g[0])))(
            jnp.asarray(feat))
    got = rp.roi_pool_backward_reference(
        torch.from_numpy(feat), torch.from_numpy(rois), torch.from_numpy(g))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_first_max_takes_the_whole_cotangent_on_a_tie():
    feat = torch.zeros(8, 8, 2)
    feat[2, 3] = feat[2, 5] = feat[4, 1] = 7.0   # three tied maxima
    rois = torch.tensor([[0, 0, 0, 63, 63]])
    g = torch.zeros(1, 1, 1, 1, 2)
    g[..., 0] = 2.0
    got = rp.roi_pool_backward_reference(feat, rois, g, 1, 1)
    assert got[0, 2, 3, 0] == 2.0 and got.sum() == 2.0


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_autograd_function_uses_the_plain_backward(dtype):
    rng = np.random.RandomState(2)
    feat = torch.from_numpy(_tied(rng, 20, 24, 4)).to(dtype)
    rois = torch.from_numpy(ROIS[1:5] * 0.5)
    g = torch.from_numpy(rng.randn(4, 7, 7, 4).astype(np.float32)).to(dtype)
    leaf = feat.clone().requires_grad_(True)
    out = rp.roi_pool(leaf, rois)
    assert out.dtype == dtype and out.requires_grad
    assert torch.equal(out.detach(), rp.roi_pool_reference(feat, rois))
    out.backward(g)
    want = rp.roi_pool_backward_reference(feat, rois, g[None])[0]
    assert leaf.grad.dtype == dtype
    assert torch.equal(leaf.grad, want.to(dtype))
    # no graph without a leaf that needs one
    assert not rp.roi_pool(feat, rois).requires_grad


def test_empty_bins_nonfinite_maxima_and_zero_seeds_pass_nothing_back():
    rng = np.random.RandomState(3)
    feat = torch.from_numpy(_tie_free(rng, 10, 10, 3))
    feat[0, 0, 0] = float('nan')
    feat[9, 9, 1] = float('inf')
    rois = torch.from_numpy(ROIS[[5, 6]])      # past the map; inverted
    g = torch.ones(2, 2, 7, 7, 3)
    got = rp.roi_pool_backward_reference(feat, rois, g)
    # the inverted box is one cell at (12, 12) -> off the 10x10 map too
    assert not got.any()
    whole = torch.tensor([[0, 0, 0, 79, 79]])
    got = rp.roi_pool_backward_reference(feat, whole, torch.ones(1, 1, 1, 1, 3),
                                         1, 1)
    assert not got[..., 0].any() and not got[..., 1].any()   # NaN, inf
    assert got[..., 2].sum() == 1.0
    zero = rp.roi_pool_backward_reference(
        feat, whole, torch.zeros(2, 1, 7, 7, 3))
    assert zero.shape == (2, 10, 10, 3) and not zero.any()
    none = rp.roi_pool_backward_reference(feat, whole[:0],
                                          torch.zeros(1, 0, 7, 7, 3))
    assert none.shape == (1, 10, 10, 3)


def test_cuda_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError):
        rp.roi_pool_backward_cuda(torch.zeros(1, 7, 7, 8, dtype=torch.int32),
                                  torch.zeros(1, 1, 7, 7, 8), 4, 4)
    with pytest.raises(ValueError):
        rp.roi_pool_cuda(torch.zeros(4, 4, 8), torch.zeros(1, 5),
                         argmax=True)


def _argmax_by_definition(feat, rois, pooled=7, scale=0.125):
    """The first-max index one bin and one channel at a time, in numpy:
    the bins of roi_pool_common.cuh, the cells in row-major order, the
    first strictly greater value wins, -1 for an empty bin or a max that is
    NaN or not finite."""
    h, w, c = feat.shape
    out = np.full((len(rois), pooled, pooled, c), -1, np.int32)
    for r, roi in enumerate(rois):
        v = np.float32(roi[1:5]) * np.float32(scale)
        x1, y1, x2, y2 = (int(np.sign(t) * np.floor(abs(t) + 0.5)) for t in v)
        rh, rw = max(y2 - y1 + 1, 1), max(x2 - x1 + 1, 1)
        for ph in range(pooled):
            hs = min(max(ph * rh // pooled + y1, 0), h)
            he = min(max(-(-(ph + 1) * rh // pooled) + y1, 0), h)
            for pw in range(pooled):
                ws = min(max(pw * rw // pooled + x1, 0), w)
                we = min(max(-(-(pw + 1) * rw // pooled) + x1, 0), w)
                for ch in range(c):
                    best, m, nan = -1, -np.inf, False
                    for y in range(hs, he):
                        for x in range(ws, we):
                            f = feat[y, x, ch]
                            nan |= bool(np.isnan(f))
                            if f > m:
                                best, m = y * w + x, f
                    if not nan and np.isfinite(m):
                        out[r, ph, pw, ch] = best
    return out


@pytest.mark.parametrize('make', [_tie_free, _tied], ids=['tie_free', 'tied'])
def test_argmax_reference_is_the_first_max_by_definition(make):
    rng = np.random.RandomState(4)
    feat = make(rng, 40, 40, 3)
    got = rp.roi_pool_argmax_reference(torch.from_numpy(feat),
                                       torch.from_numpy(ROIS))
    assert got.dtype == torch.int32 and got.shape == (len(ROIS), 7, 7, 3)
    np.testing.assert_array_equal(got.numpy(),
                                  _argmax_by_definition(feat, ROIS))
    assert (got == -1).any() and (got >= 0).any()


@pytest.mark.parametrize('make', [_tie_free, _tied], ids=['tie_free', 'tied'])
def test_scatter_of_the_argmax_routes_as_the_interpreted_tpu_kernel(make):
    """Integer cotangents: the sums are exact, so the routing is compared
    bitwise; the index also agrees with the composed plain backward."""
    rng = np.random.RandomState(5)
    feat = make(rng, 40, 40, 8)
    g = rng.randint(-3, 4, (2, len(ROIS), 7, 7, 8)).astype(np.float32)
    argmax = rp.roi_pool_argmax_reference(torch.from_numpy(feat),
                                          torch.from_numpy(ROIS))
    got = rp.roi_pool_scatter_reference(argmax, torch.from_numpy(g), 40, 40)
    assert got.shape == (2, 40, 40, 8) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _interpret(feat, ROIS, g))
    assert torch.equal(got, rp.roi_pool_backward_reference(
        torch.from_numpy(feat), torch.from_numpy(ROIS), torch.from_numpy(g)))


@pytest.mark.parametrize('make', [_tie_free, _tied], ids=['tie_free', 'tied'])
def test_argmax_matches_the_jax_custom_call_on_finite_maps(make):
    if not jax_rp._ffi_ok():
        pytest.skip('the JAX package built no CPU custom call here')
    rng = np.random.RandomState(6)
    feat = make(rng, 40, 40, 8)
    _, want = jax_rp._roi_pool_ffi_raw(jnp.asarray(feat), jnp.asarray(ROIS),
                                       7, 7, 0.125)
    got = rp.roi_pool_argmax_reference(torch.from_numpy(feat),
                                       torch.from_numpy(ROIS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_matches_the_jax_saved_argmax_scatter():
    rng = np.random.RandomState(7)
    feat = _tied(rng, 40, 40, 8)
    argmax = rp.roi_pool_argmax_reference(torch.from_numpy(feat),
                                          torch.from_numpy(ROIS))
    g = rng.randn(len(ROIS), 7, 7, 8).astype(np.float32)
    want = jax_rp.argmax_scatter_grad(jnp.asarray(argmax.numpy()),
                                      jnp.asarray(g), 40, 40)
    got = rp.roi_pool_scatter_reference(argmax, torch.from_numpy(g)[None],
                                        40, 40)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_nan_and_inf_bins_get_no_index():
    """A bin with a NaN, a bin whose max is +inf and a bin of -inf cells
    all get -1 (the forward writes 0 there), as does an empty bin; a bin
    where -inf is not the max keeps its finite max."""
    feat = torch.ones(8, 8, 4)
    feat[0, 0, 0] = float('nan')
    feat[0, 0, 1] = float('inf')
    feat[:, :, 2] = -math.inf
    feat[0, 0, 3] = -math.inf
    rois = torch.tensor([[0, 0, 0, 7, 7], [0, 200, 200, 260, 260]])
    argmax = rp.roi_pool_argmax_reference(feat, rois, 1, 1, 1.0)
    assert argmax[0, 0, 0].tolist() == [-1, -1, -1, 1]
    assert (argmax[1] == -1).all()
    out = rp.roi_pool_reference(feat, rois, 1, 1, 1.0)
    assert out[0, 0, 0].tolist() == [0.0, 0.0, 0.0, 1.0]
    g = torch.ones(1, 2, 1, 1, 4)
    dfeat = rp.roi_pool_scatter_reference(argmax, g, 8, 8)
    assert dfeat[0, 0, 1, 3] == 1.0 and dfeat.sum() == 1.0


def test_autograd_function_saves_the_index_not_the_map():
    rng = np.random.RandomState(8)
    feat = torch.from_numpy(_tie_free(rng, 20, 24, 4)).requires_grad_(True)
    rois = torch.from_numpy(ROIS[1:5] * 0.5)
    out = rp.roi_pool(feat, rois)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].dtype == torch.int32
    assert torch.equal(saved[0], rp.roi_pool_argmax_reference(feat.detach(),
                                                              rois))
    # two backwards through one graph (the CPG seeds) reuse the index
    g = torch.ones_like(out)
    first, = torch.autograd.grad(out, feat, g, retain_graph=True)
    second, = torch.autograd.grad(out, feat, 2 * g)
    assert torch.equal(second, 2 * first) and first.sum() > 0
