"""The port's losses, RoI IoU and spatial-entropy weights
(nafwebsod_torch/ops/losses.py, jbox.py, entropy.py) against the JAX
package on the same seeded numpy inputs, on the CPU.

Tolerances: CE values at 1e-6 and gradients at 1e-5 (relative; the same
float32 formula on both sides, sums reassociated), entropy weights at
1e-5, ``roi_iou`` exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafwebsod_tpu.ops import entropy as jax_entropy
from nafwebsod_tpu.ops import jbox as jax_jbox
from nafwebsod_tpu.ops import losses as jax_losses
from nafwebsod_torch.ops import entropy, jbox, losses


def _probs(seed, n=1, c=6):
    rng = np.random.RandomState(seed)
    probs = rng.uniform(0.02, 0.98, (n, c)).astype(np.float32)
    # exactly 0 and 1, and values whose gradient exceeds the 1e4 clamp
    probs[0, 0], probs[0, 1], probs[0, 2] = 0.0, 1.0, 1e-7
    probs[0, 3] = 1.0 - 1e-6
    labels = (rng.rand(n, c) > 0.5).astype(np.float32)
    labels[0, :4] = [0, 1, 1, 0]
    labels[0, 4] = 0.3  # a mixup-blended label
    weights = rng.uniform(0, 1, (1, c)).astype(np.float32)
    return probs, labels, weights


@pytest.mark.parametrize('is_mean', [False, True])
@pytest.mark.parametrize('n', [1, 3])
def test_cross_entropy_value_and_gradient_match_jax(is_mean, n):
    probs, labels, _ = _probs(n, n)
    want, want_grad = jax.value_and_grad(
        lambda p: 3.0 * jax_losses.cross_entropy_with_logits(
            p, jnp.asarray(labels), is_mean))(jnp.asarray(probs))
    p = torch.from_numpy(probs).requires_grad_(True)
    got = 3.0 * losses.cross_entropy_with_logits(
        p, torch.from_numpy(labels), is_mean)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5)


@pytest.mark.parametrize('is_mean', [False, True])
def test_weighted_cross_entropy_value_and_gradient_match_jax(is_mean):
    probs, labels, weights = _probs(7)
    want, want_grad = jax.value_and_grad(
        lambda p: jax_losses.weighted_cross_entropy_with_logits(
            p, jnp.asarray(labels), jnp.asarray(weights), is_mean))(
                jnp.asarray(probs))
    p = torch.from_numpy(probs).requires_grad_(True)
    got = losses.weighted_cross_entropy_with_logits(
        p, torch.from_numpy(labels), torch.from_numpy(weights), is_mean)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5)


def test_gradient_is_clamped_before_the_weight_and_the_mean():
    """p = 1e-7 with label 0 is fine, p = 1 - 1e-6 with label 0 gives
    1 / 1e-6 > 1e4: clamped to 1e4, then weighted and divided by N. Plain
    autograd of the forward would give 1e6 * w / N."""
    probs = torch.tensor([[1.0 - 1e-6, 0.5], [0.5, 0.5]], requires_grad=True)
    labels = torch.zeros(2, 2)
    weights = torch.tensor([[0.25, 1.0]])
    losses.weighted_cross_entropy_with_logits(
        probs, labels, weights).backward()
    assert probs.grad[0, 0].item() == pytest.approx(1e4 * 0.25 / 2)
    assert probs.grad[1, 1].item() == pytest.approx(2.0 / 2)


def test_multilabel_accuracy_matches_jax():
    probs, labels, _ = _probs(3)
    labels = np.round(labels)
    want = jax_losses.multilabel_accuracy(jnp.asarray(probs),
                                          jnp.asarray(labels))
    got = losses.multilabel_accuracy(torch.from_numpy(probs),
                                     torch.from_numpy(labels))
    assert got.item() == float(want)


def _rois(rng, r, size=60.0):
    x1 = rng.uniform(0, size - 20, r)
    y1 = rng.uniform(0, size - 20, r)
    return np.stack([np.zeros(r), x1, y1, x1 + rng.uniform(4, 20, r),
                     y1 + rng.uniform(4, 20, r)], 1).astype(np.float32)


def test_roi_iou_is_exact():
    rng = np.random.RandomState(0)
    rois = _rois(rng, 24)
    rois[5] = rois[0]            # a duplicate: IoU 1 off the diagonal too
    rois[7, 1:] = [50.9, 50.9, 51.2, 51.2]   # truncates to one pixel
    want = np.asarray(jax_jbox.roi_iou(jnp.asarray(rois)))
    got = jbox.roi_iou(torch.from_numpy(rois)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.diag(got) == 1.0).all()


@pytest.mark.parametrize('padded', [False, True])
def test_entropy_weights_match_jax(padded):
    rng = np.random.RandomState(1)
    r, c = 32, 5
    rois = _rois(rng, r)
    logits = rng.randn(r, c).astype(np.float32) * 3
    valid = np.ones(r, bool)
    if padded:
        valid[24:] = False
        rois[24:] = 0
    alpha = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    det = np.where(valid[:, None], np.exp(logits.T[::-1].T), 0)
    rois_pred = (alpha * det / det.sum(0, keepdims=True)).astype(np.float32)
    rois_pred[3, 2] = 0.0        # 0 * log 0 -> NaN -> 0
    rois_pred[:, 4] = 0.0        # a class nobody scores: cls_prob == 0
    cls_prob = rois_pred.sum(0, keepdims=True)
    labels = np.array([[1, 0, 0.4, 0, 0]], np.float32)
    mask = valid if padded else None
    want = jax_entropy.spatial_entropy_weights(
        jnp.asarray(rois_pred), jnp.asarray(cls_prob), jnp.asarray(rois),
        jnp.asarray(labels), None if mask is None else jnp.asarray(mask))
    got = entropy.spatial_entropy_weights(
        torch.from_numpy(rois_pred), torch.from_numpy(cls_prob),
        torch.from_numpy(rois), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    for g, w in zip(got, want):
        assert g.shape == (1, c) and not g.requires_grad
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    assert (got[1].numpy() > 0).any()   # the weighting is not trivial
