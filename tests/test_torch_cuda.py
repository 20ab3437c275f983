"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Marked ``cuda``: they skip without a card. Imports neither JAX
nor the JAX package, so the card's machine runs them without
tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: bitwise (max pooling selects an element, it rounds nothing).
"""

import numpy as np
import pytest
import torch

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
