"""The port's RoIAlign (ops/roi_pool.py: ``roi_align``, its plain version
``roi_align_reference``) against the JAX package on the CPU: ``roi_align_xla``
and the interpret-mode Pallas kernel, on numpy-seeded inputs.

Tolerances. On RoIs whose sample coordinates are exact in float32 (boxes of
``pooled * 4`` cells on integer starts: every sample is an integer or a
half), the three differ only in the order of a bin's sums: rtol 1e-5, atol
1e-6, at which the JAX package holds its own kernel to ``roi_align_xla``
(tests/test_pallas_interpret.py). On arbitrary RoIs, XLA's CPU code rounds
the coordinate expression ``start + p * bin + (s + 0.5) * bin / sr``
otherwise than its float32 operations taken one by one (it contracts
products and sums), in about a fifth of the samples by one unit in the last
place. A coordinate below ``limit`` that moves by one ulp, at most
``eps * limit``, moves a bilinear weight by as much, and the value by that
times the spread of the map, on each axis: atol ``2 * eps * limit *
(max - min)``. The port keeps the operations one by one, as its CUDA kernel
spells them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafwebsod_tpu.models import heads as jax_heads
from nafwebsod_tpu.ops.pallas.roi_align_pallas import roi_align_pallas
from nafwebsod_tpu.ops.roi_pool import roi_align as jax_roi_align
from nafwebsod_tpu.ops.roi_pool import roi_align_xla
from nafwebsod_torch.models import heads
from nafwebsod_torch.ops import roi_pool as rp

EPS = float(np.finfo(np.float32).eps)
ORDER_TOL = dict(rtol=1e-5, atol=1e-6)
JAX_DTYPES = {'float32': jnp.float32, 'bfloat16': jnp.bfloat16}
TORCH_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _coord_tol(feat, limit):
    return dict(rtol=1e-5, atol=2 * EPS * limit * float(feat.max()
                                                        - feat.min()))


def _rois(rng, r, span):
    """MCG-like boxes in image coordinates inside [0, span)."""
    x1 = rng.uniform(0, span - 16, r)
    y1 = rng.uniform(0, span - 16, r)
    w = np.exp(rng.uniform(np.log(8), np.log(span), r))
    h = np.exp(rng.uniform(np.log(8), np.log(span), r))
    return np.stack([np.zeros(r), x1, y1, np.minimum(x1 + w, span - 1),
                     np.minimum(y1 + h, span - 1)], 1).astype(np.float32)


def _exact_rois(rng, r, pooled, size):
    """Boxes of pooled * 4 cells from integer cells, at scale 1/8: the bin
    is 4 cells and every sample an integer (start + 4 p + 1 or + 3)."""
    start = rng.randint(-6, size - 4, (r, 2)).astype(np.float32)
    rois = np.concatenate([np.zeros((r, 1), np.float32), start * 8,
                           (start + pooled * 4) * 8], 1)
    return rois.astype(np.float32)


def _feat(rng, size, c, dtype):
    feat = rng.randn(size, size, c).astype(np.float32)
    if dtype == 'bfloat16':       # bfloat16-representable float32 values
        feat = torch.from_numpy(feat).bfloat16().float().numpy()
    return feat


def _port(feat, rois, res, dtype, **kw):
    return rp.roi_align(torch.from_numpy(feat).to(TORCH_DTYPES[dtype]),
                        torch.from_numpy(rois), res, res, 0.125, 2, **kw)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('res', [7, 14])
def test_reference_matches_xla_and_the_interpreted_kernel(res, dtype):
    rng = np.random.RandomState(res)
    feat = _feat(rng, 40, 8, dtype)
    rois = _rois(rng, 24, 320)
    got = _port(feat, rois, res, dtype, out_dtype=torch.float32).numpy()
    assert got.shape == (24, res, res, 8) and got.dtype == np.float32
    jf = jnp.asarray(feat).astype(JAX_DTYPES[dtype])
    want = np.asarray(roi_align_xla(jf, jnp.asarray(rois), res, res, 0.125, 2))
    assert want.dtype == np.float32
    kernel = np.asarray(roi_align_pallas(jf, jnp.asarray(rois), res, res,
                                         0.125, 2, interpret=True))
    np.testing.assert_allclose(got, want, **_coord_tol(feat, 40))
    np.testing.assert_allclose(got, kernel, **_coord_tol(feat, 40))
    # most outputs agree to the order of the sums alone
    close = np.isclose(got, want, **ORDER_TOL)
    assert close.mean() > 0.8


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('res', [7, 14])
def test_reference_on_exact_coordinates_differs_by_the_sums_order_only(
        res, dtype):
    rng = np.random.RandomState(10 + res)
    feat = _feat(rng, 40, 8, dtype)
    rois = _exact_rois(rng, 32, res, 40)
    got = _port(feat, rois, res, dtype, out_dtype=torch.float32).numpy()
    jf = jnp.asarray(feat).astype(JAX_DTYPES[dtype])
    want = np.asarray(roi_align_xla(jf, jnp.asarray(rois), res, res, 0.125, 2))
    kernel = np.asarray(roi_align_pallas(jf, jnp.asarray(rois), res, res,
                                         0.125, 2, interpret=True))
    np.testing.assert_allclose(got, want, **ORDER_TOL)
    np.testing.assert_allclose(got, kernel, **ORDER_TOL)
    assert np.abs(got).max() > 0.1


def _np_roi_align(feat, roi, pooled, scale, sr, closed=True):
    """The definition, one sample at a time, in float64 on float32
    coordinates. ``closed=False``: what an open validity interval
    (-1, limit) would give."""
    h, w, c = feat.shape
    f32 = np.float32
    sw, sh, ew, eh = (f32(v) * f32(scale) for v in roi[1:5])
    bin_w = f32(max(ew - sw, f32(1))) / f32(pooled)
    bin_h = f32(max(eh - sh, f32(1))) / f32(pooled)
    out = np.zeros((pooled, pooled, c))
    for ph in range(pooled):
        for pw in range(pooled):
            for iy in range(sr):
                for ix in range(sr):
                    y = f32(f32(sh + f32(ph) * bin_h)
                            + f32(f32(iy + 0.5) * bin_h) / f32(sr))
                    x = f32(f32(sw + f32(pw) * bin_w)
                            + f32(f32(ix + 0.5) * bin_w) / f32(sr))
                    if not (-1 <= y <= h and -1 <= x <= w):
                        continue
                    if not closed and (y in (-1, h) or x in (-1, w)):
                        continue
                    y = min(max(float(y), 0.0), h - 1.0)
                    x = min(max(float(x), 0.0), w - 1.0)
                    y0, x0 = int(np.floor(y)), int(np.floor(x))
                    y1, x1 = min(y0 + 1, h - 1), min(x0 + 1, w - 1)
                    ly, lx = y - y0, x - x0
                    out[ph, pw] += (feat[y0, x0] * (1 - ly) * (1 - lx)
                                    + feat[y0, x1] * (1 - ly) * lx
                                    + feat[y1, x0] * ly * (1 - lx)
                                    + feat[y1, x1] * ly * lx)
    return out / (sr * sr)


# Edge rows on a (40, 40) map at scale 1/8: boxes of 56 (14 bins) or 28
# (7 bins) cells have a bin of 4 cells, so the first sample of a box that
# starts at cell -2 sits at exactly -1 and the last sample of a box that
# ends at cell 41 at exactly 40.
EDGE_ROIS = np.array([
    [0, -16, -120, 432, 328],       # 14 bins: x from -1, y to H, exactly
    [0, -120, -16, 328, 432],       # 14 bins: x to W, y from -1, exactly
    [0, -16, 104, 208, 328],        # 7 bins: x from -1, y to H, exactly
    [0, 104, -16, 328, 208],        # 7 bins: x to W, y from -1, exactly
    [0, 200, 150, 600, 500],        # past the right and the bottom edge
    [0, 100.3, 100.7, 101.1, 102.9],    # inside one cell: extents floored at 1
    [0, 300, 200, 100, 50],         # inverted: extents floored at 1
    [0, 2000, 2000, 2100, 2100],    # off the map: every sample counts 0
    [0, -500, -500, -100, -100],    # off the map on the other side
    [0, 0, 0, 319, 319],            # the image
    [0, 0, 0, 0, 0],                # a padded row
], np.float32)


@pytest.mark.parametrize('res', [7, 14])
def test_reference_on_the_edge_rows(res):
    """The closed validity interval [-1, limit], the clipping and the
    floored extents, against the definition written out in numpy and
    against ``roi_align_xla``."""
    rng = np.random.RandomState(3)
    feat = rng.randn(40, 40, 4).astype(np.float32)
    got = _port(feat, EDGE_ROIS, res, 'float32').numpy()
    golden = np.stack([_np_roi_align(feat.astype(np.float64), roi, res,
                                     0.125, 2) for roi in EDGE_ROIS])
    np.testing.assert_allclose(got, golden, rtol=1e-5, atol=2e-5)
    want = np.asarray(roi_align_xla(jnp.asarray(feat), jnp.asarray(EDGE_ROIS),
                                    res, res, 0.125, 2))
    np.testing.assert_allclose(got, want, **_coord_tol(feat, 40))
    assert np.isfinite(got).all()
    assert not got[7].any() and not got[8].any()      # off the map: zeros
    assert got[-1].any() and got[5].any() and got[6].any()
    # a sample at exactly -1 or exactly H counts: with an open interval
    # the row built for this resolution would lose its first column's and
    # its last row's outer samples
    row = 0 if res == 14 else 2
    open_ended = _np_roi_align(feat.astype(np.float64), EDGE_ROIS[row], res,
                               0.125, 2, closed=False)
    assert np.abs(open_ended[:, 0] - golden[row][:, 0]).max() > 1e-3
    assert np.abs(open_ended[-1] - golden[row][-1]).max() > 1e-3


def test_non_finite_cells_under_a_zero_weight_give_nan_as_in_jax():
    """RoIAlign has no "non-finite -> 0" rule: the four-corner form
    multiplies a NaN cell by a zero weight and gets NaN; an invalid
    sample's whole value is multiplied by 0 likewise."""
    rng = np.random.RandomState(4)
    feat = rng.randn(40, 40, 4).astype(np.float32)
    feat[10, 12, 1] = np.nan
    feat[39, 39, 2] = np.inf
    rois = np.concatenate([_exact_rois(rng, 24, 7, 40), EDGE_ROIS])
    got = _port(feat, rois, 7, 'float32').numpy()
    want = np.asarray(roi_align_xla(jnp.asarray(feat), jnp.asarray(rois), 7,
                                    7, 0.125, 2))
    assert np.isnan(got).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], **_coord_tol(
        np.nan_to_num(feat, posinf=0.0), 40))
    assert np.isfinite(got[..., 0]).all() and np.isfinite(got[..., 3]).all()


def test_out_dtype_and_bfloat16_promotion():
    rng = np.random.RandomState(5)
    feat = _feat(rng, 24, 4, 'bfloat16')
    rois = _rois(rng, 8, 192)
    as_f32 = _port(feat, rois, 7, 'bfloat16', out_dtype=torch.float32)
    default = _port(feat, rois, 7, 'bfloat16')
    assert as_f32.dtype == torch.float32 and default.dtype == torch.bfloat16
    # float32 products of the bfloat16 cells, rounded once at the end
    assert torch.equal(default, as_f32.bfloat16())
    assert torch.equal(as_f32, _port(feat, rois, 7, 'float32'))
    assert _port(feat, rois, 7, 'float32').dtype == torch.float32
    want = jax_roi_align(jnp.asarray(feat).astype(jnp.bfloat16),
                         jnp.asarray(rois), 7, 7, 0.125, 2)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(default.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-3)


def test_chunks_and_empty_inputs():
    rng = np.random.RandomState(6)
    feat = torch.from_numpy(_feat(rng, 24, 4, 'float32'))
    rois = torch.from_numpy(_rois(rng, 11, 192))
    whole = rp.roi_align_reference(feat, rois, 14, 14, 0.125, 2)
    assert torch.equal(whole, rp.roi_align_reference(feat, rois, 14, 14,
                                                     0.125, 2, chunk=3))
    empty = rp.roi_align(feat, rois[:0], 14, 14)
    assert empty.shape == (0, 14, 14, 4) and empty.dtype == torch.float32
    one = rp.roi_align_reference(feat, rois, 7, 7, 0.125, 1)
    three = rp.roi_align_reference(feat, rois, 7, 7, 0.125, 3)
    assert one.shape == three.shape and not torch.equal(one, three)
    want = np.asarray(roi_align_xla(jnp.asarray(feat.numpy()),
                                    jnp.asarray(rois.numpy()), 7, 7, 0.125,
                                    3))
    np.testing.assert_allclose(three.numpy(), want,
                               **_coord_tol(feat.numpy(), 24))


def test_roi_align_refuses_what_it_cannot_do():
    feat = torch.zeros(8, 8, 4)
    rois = torch.tensor([[0.0, 0, 0, 30, 30]])
    for sr in (0, -1):
        with pytest.raises(ValueError, match='sampling_ratio'):
            rp.roi_align(feat, rois, 7, 7, 0.125, sr)
    with pytest.raises(NotImplementedError, match='K4 backward'):
        rp.roi_align(feat.clone().requires_grad_(True), rois)
    with torch.no_grad():     # no graph is asked for: the forward runs
        assert rp.roi_align(feat.clone().requires_grad_(True),
                            rois).shape == (1, 7, 7, 4)
    with pytest.raises(ValueError, match='unsupported device'):
        rp.roi_align(feat.to('meta'), rois.to('meta'))
    with pytest.raises(ValueError, match='CUDA tensor'):
        rp.roi_align_cuda(feat, rois)      # a CPU map never reaches a kernel
    assert rp.roi_align_cuda.launches == 0


@pytest.mark.parametrize('freeze', [True, False])
def test_roi_transform_with_roi_align_matches_jax(freeze):
    rng = np.random.RandomState(7)
    feat = np.maximum(rng.randn(1, 40, 40, 8), 0).astype(np.float32)
    rois = _exact_rois(rng, 16, 7, 40)
    obn = (rng.rand(16, 1) + 1).astype(np.float32)
    want = jax_heads.roi_transform(
        jnp.asarray(feat[0]), jnp.asarray(rois), jnp.asarray(obn), 0.125,
        method='RoIAlign', resolution=7, sampling_ratio=2,
        freeze_body=freeze)
    got = heads.roi_transform(
        torch.from_numpy(feat[0]), torch.from_numpy(rois),
        torch.from_numpy(obn), 0.125, 7, freeze, 'RoIAlign', 2)
    assert got.shape == (16, 8 * 7 * 7) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ORDER_TOL)
    pooled = heads.roi_transform(
        torch.from_numpy(feat[0]), torch.from_numpy(rois),
        torch.from_numpy(obn), 0.125, 7, freeze)
    assert not torch.equal(pooled, got)            # RoIPoolF by default
