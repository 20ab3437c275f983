"""The port's RoIPoolF (nafwebsod_torch/ops/roi_pool.py) against the JAX
package's two K1 references on the CPU: ``roi_pool_xla`` and the Pallas
kernel ``roi_pool_pallas`` in interpret mode. Tolerance: bitwise, in
float32 and bfloat16 (max pooling selects an element, it rounds nothing).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafwebsod_tpu.ops.pallas.roi_pool_pallas import roi_pool_pallas
from nafwebsod_tpu.ops.roi_pool import roi_feature_boost as jax_boost
from nafwebsod_tpu.ops.roi_pool import roi_pool_xla
from nafwebsod_torch.ops import roi_pool as rp

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def edge_case_rois(rng, r, im_w, im_h):
    """Proposals as the flagship meets them, clipped to the image: sizes
    from 8 px to the whole image, coordinates whose x/8 is exactly .5
    (rounding half away from zero), boxes reaching the image edge and so
    past the conv map's edge, and degenerate boxes (x2 < x1, points) whose
    bins come out empty or one cell wide."""
    x1 = rng.uniform(0, im_w - 8, r)
    y1 = rng.uniform(0, im_h - 8, r)
    span = rng.choice([8, 32, 120, 400, 4000], (r, 2))
    rois = np.stack([np.zeros(r), x1, y1, x1 + span[:, 0], y1 + span[:, 1]],
                    1)
    n = r // 8
    rois[:n, 1:] = (rng.randint(0, min(im_w, im_h) // 8, (n, 4)) * 8
                    + 4.0)                                   # x/8 = k + .5
    rois[n:2 * n, 3] = rois[n:2 * n, 1] - rng.uniform(1, 40, n)  # x2 < x1
    rois[2 * n:3 * n, 3:5] = rois[2 * n:3 * n, 1:3]              # points
    rois[3 * n, 1:] = [0, 0, im_w - 1, im_h - 1]                 # whole image
    rois[:, 1:] = np.clip(rois[:, 1:], 0, [im_w - 1, im_h - 1] * 2)
    return rois.astype(np.float32)


def _features(rng, h, w, c, jdt):
    return jnp.asarray(rng.randn(h, w, c).astype(np.float32)).astype(jdt)


def _to_torch(x, tdt):
    return torch.tensor(np.asarray(x.astype(jnp.float32))).to(tdt)


@pytest.mark.parametrize('jdt,tdt', DTYPES, ids=['f32', 'bf16'])
@pytest.mark.parametrize('h,w,c,im_w,im_h', [
    (40, 41, 8, 336, 328),      # map of a 336x328 image at scale 1/8
    (12, 9, 16, 80, 104),       # map narrower than two bins per cell
])
def test_reference_matches_both_jax_references(jdt, tdt, h, w, c, im_w,
                                               im_h):
    rng = np.random.RandomState(h * w)
    feat = _features(rng, h, w, c, jdt)
    rois = edge_case_rois(rng, 64, im_w, im_h)
    xla = np.asarray(roi_pool_xla(feat, jnp.asarray(rois), 7, 7, 0.125)
                     .astype(jnp.float32))
    pallas = np.asarray(roi_pool_pallas(feat, jnp.asarray(rois), 7, 7,
                                        0.125, interpret=True)
                        .astype(jnp.float32))
    ours = rp.roi_pool_reference(_to_torch(feat, tdt), torch.from_numpy(rois))
    assert ours.dtype == tdt
    ours = ours.float().numpy()
    np.testing.assert_array_equal(ours, xla)
    np.testing.assert_array_equal(ours, pallas)
    assert (ours == 0).all(axis=-1).any()  # some bins are empty


def _brute_force(feat, rois, pooled, scale):
    """RoIPoolF by its definition, one bin at a time."""
    h, w, c = feat.shape
    out = np.zeros((len(rois), pooled, pooled, c), feat.dtype)
    for i, roi in enumerate(rois):
        v = roi[1:5].astype(np.float32) * np.float32(scale)
        x1, y1, x2, y2 = (np.sign(v) * np.floor(np.abs(v) + 0.5)).astype(int)
        rh, rw = max(y2 - y1 + 1, 1), max(x2 - x1 + 1, 1)
        for ph in range(pooled):
            hs = min(max(ph * rh // pooled + y1, 0), h)
            he = min(max(-(-(ph + 1) * rh // pooled) + y1, 0), h)
            for pw in range(pooled):
                ws = min(max(pw * rw // pooled + x1, 0), w)
                we = min(max(-(-(pw + 1) * rw // pooled) + x1, 0), w)
                if he > hs and we > ws:
                    out[i, ph, pw] = feat[hs:he, ws:we].max(axis=(0, 1))
    return out


def test_reference_is_exact_for_rois_outside_the_image():
    """Unclipped RoIs far past the map: the plain version (like the CUDA
    kernel) keeps the exact definition, where roi_pool_xla's fixed
    gather windows assume image-clipped RoIs."""
    rng = np.random.RandomState(4)
    feat = rng.randn(20, 23, 4).astype(np.float32)
    x1 = rng.uniform(-60, 300, 40)
    y1 = rng.uniform(-60, 300, 40)
    rois = np.stack([np.zeros(40), x1, y1,
                     x1 + rng.choice([-9, 0, 8, 300, 900], 40),
                     y1 + rng.choice([-9, 0, 8, 300, 900], 40)],
                    1).astype(np.float32)
    ours = rp.roi_pool_reference(torch.from_numpy(feat),
                                 torch.from_numpy(rois), 7, 7, 0.125)
    np.testing.assert_array_equal(ours.numpy(),
                                  _brute_force(feat, rois, 7, 0.125))


@pytest.mark.parametrize('jdt,tdt', DTYPES, ids=['f32', 'bf16'])
def test_dispatch_and_boost_on_cpu(jdt, tdt):
    rng = np.random.RandomState(7)
    feat = _features(rng, 16, 18, 4, jdt)
    rois = edge_case_rois(rng, 16, 144, 128)
    obn = (rng.rand(16, 1) + 1).astype(np.float32)
    pooled = rp.roi_pool(_to_torch(feat, tdt), torch.from_numpy(rois))
    boosted = rp.roi_feature_boost(pooled, torch.from_numpy(obn))
    want = jax_boost(roi_pool_xla(feat, jnp.asarray(rois)), jnp.asarray(obn))
    assert boosted.dtype == tdt
    np.testing.assert_array_equal(boosted.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_round_half_away_from_zero():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 0.49999997, 3.49])
    np.testing.assert_array_equal(rp._round_half_away(x).numpy(),
                                  [1, 2, 3, -1, -3, 1, 3])
    assert torch.round(torch.tensor(2.5)).item() == 2.0  # the trap


def test_cuda_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError):
        rp.roi_pool_cuda(torch.zeros(4, 4, 2), torch.zeros(1, 5))
