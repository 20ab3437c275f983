"""The port's CPG saliency and CSC weights (nafwebsod_torch/ops/cpg.py and
Detector.forward_cpg_maps) against the JAX package on the CPU, in float32,
without dropout and with ``cpg_tau=0`` so that random weights give active
seeds.

Tolerances: ring scores, normalisation and weights at rtol 1e-5 (integer
counts from the integral image, then a few float32 operations); saliency
maps at atol 2e-3 of their max of 1 (an image gradient through 13 float32
convolutions and two fc layers). A cell at the binarisation threshold may
fall on either side, so the weights are compared on one set of maps (the
JAX package's), and the two sets of binarised maps may differ in at most
3 cells of 48 x 48.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafwebsod_tpu.models import detector as jax_detector
from nafwebsod_tpu.ops import cpg as jax_cpg
from nafwebsod_torch.models import detector
from nafwebsod_torch.ops import cpg
from nafwebsod_torch.utils.bridge import params_from_jax


def test_ring_scores_match_jax():
    rng = np.random.RandomState(0)
    cpg_map = rng.rand(40, 48).astype(np.float32)
    rois = np.array([[0, 5, 5, 30, 30], [0, 0, 0, 47, 39],
                     [0, 10, 12, 46, 38], [0, -2, 3, 20, 20],
                     [0, 20, 20, 47, 39], [0, 2.5, 3.5, 20.5, 21.5],
                     [0, 0, 0, 0, 0]], np.float32)
    want = jax_cpg.csc_scores_one_class(jnp.asarray(cpg_map),
                                        jnp.asarray(rois), 0.5)
    got = cpg.csc_scores_one_class(torch.from_numpy(cpg_map),
                                   torch.from_numpy(rois), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert got[3] == cpg.KMIN_SCORE and got[6] == cpg.KMIN_SCORE


@pytest.mark.parametrize('scores', [
    [2.0, -4.0, 1.0, cpg.KMIN_SCORE], [-1.0, -2.0, 0.0],
    [3.0, 0.0, 1.5, cpg.KMIN_SCORE], [cpg.KMIN_SCORE, cpg.KMIN_SCORE]])
def test_normalize_class_matches_jax(scores):
    want = jax_cpg._normalize_class(jnp.asarray(scores, jnp.float32))
    got = cpg._normalize_class(torch.tensor(scores, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_constraint_polarity_and_constant_weight():
    rp = torch.ones(3, 2, requires_grad=True)
    w = torch.tensor([[0.5, -0.25], [1.0, 0.0], [-1.0, 2.0]],
                     requires_grad=True)
    pos = cpg.csc_constraint(rp, w, True)
    neg = cpg.csc_constraint(rp, w, False)
    np.testing.assert_allclose(pos.detach().numpy(),
                               [[0.5, 0], [1, 0], [0, 2]])
    np.testing.assert_allclose(neg.detach().numpy(),
                               [[0, 0.25], [0, 0], [1, 0]])
    (pos.sum() + neg.sum()).backward()
    assert w.grad is None and rp.grad is not None


@pytest.mark.parametrize('labels,max_gt', [
    ([0, 1, 0, 1], 4), ([1, 1, 1, 1], 2), ([0, 0, 0.4, 0.6], 3),
    ([1, 0, 0, 0], 6)])
def test_select_gt_classes_matches_jax(labels, max_gt):
    oh = np.asarray([labels], np.float32)
    want, _ = jax_cpg.select_gt_classes(jnp.asarray(oh), max_gt)
    assert cpg.select_gt_classes(torch.from_numpy(oh), max_gt) == \
        np.asarray(want).tolist()


def test_class_zero_not_clobbered_by_padding():
    """tests/test_cpg.py::TestCSCWeightsScatter: padded slots (-1) must
    leave class 0's blended weights alone."""
    rng = np.random.RandomState(0)
    r, c, max_gt = 8, 4, 4
    m0 = np.zeros((48, 48), np.float32)
    m0[8:28, 8:28] = 1.0
    maps = np.stack([m0] * max_gt)
    rois = np.stack([np.zeros(r), rng.uniform(0, 20, r),
                     rng.uniform(0, 20, r), rng.uniform(24, 46, r),
                     rng.uniform(24, 46, r)], 1).astype(np.float32)
    rois[0] = [0, 8, 8, 27, 27]
    labels = np.zeros((1, c), np.float32)
    labels[0, 0] = 1
    cls_prob = np.full((1, c), 0.9, np.float32)
    idx = [0, -1, -1, -1]
    keep = np.array([True, False, False, False])
    valid = np.arange(r) < 6
    want, _, _ = jax_cpg.csc_weights(
        jnp.asarray(maps), jnp.asarray(idx), jnp.asarray(keep),
        jnp.asarray(rois), jnp.asarray(labels), jnp.asarray(cls_prob),
        valid_mask=jnp.asarray(valid))
    w, pos, neg = cpg.csc_weights(
        torch.from_numpy(maps), idx, torch.from_numpy(keep),
        torch.from_numpy(rois), torch.from_numpy(labels),
        torch.from_numpy(cls_prob), valid_mask=torch.from_numpy(valid))
    np.testing.assert_allclose(w.numpy(), np.asarray(want), rtol=1e-5)
    assert not np.allclose(w.numpy()[:, 0], 1.0)
    np.testing.assert_allclose(w.numpy()[:, 1:], 1.0)
    np.testing.assert_allclose(w.numpy()[6:, 0], 0.9 * -1 + 0.1, rtol=1e-6)
    assert torch.equal(pos, torch.from_numpy(labels)) and not neg.any()


FG = 0.5  # sparse binarised maps: some RoIs score positive, some negative


def csc_fixture(r=12, padded=4, seed=1):
    """A CSC model pair on bridged weights and one padded batch (numpy)."""
    spec = jax_detector.ModelSpec(
        num_classes=5, hidden_dim=16, webly_on=False, webly_entropy=False,
        box_head='vgg16_2fc', csc=True, cpg_tau=0.0,
        csc_fg_threshold=FG, compute_dtype='float32')
    params = {k: np.asarray(v) for k, v in jax_detector.init_params(
        spec, jax.random.PRNGKey(seed)).items()}
    model = detector.build_model(detector.ModelSpec(
        num_classes=5, hidden_dim=16, webly_on=False, webly_entropy=False,
        box_head='vgg16_2fc', csc=True, cpg=True, cpg_tau=0.0,
        csc_fg_threshold=FG), device='cpu')
    model.load_state_dict(params_from_jax(params))
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(0, 24, r)
    y1 = rng.uniform(0, 24, r)
    rois = np.stack([np.zeros(r), x1, y1, x1 + rng.uniform(8, 22, r),
                     y1 + rng.uniform(8, 22, r)], 1).astype(np.float32)
    valid = np.arange(r) < r - padded
    rois[~valid] = 0
    obn = (rng.rand(r, 1) + 1).astype(np.float32)
    obn[~valid] = 0
    labels = np.zeros((1, 4), np.float32)
    labels[0, [0, 2]] = 1
    batch = {'image': rng.randn(1, 48, 48, 3).astype(np.float32),
             'rois': rois, 'obn_scores': obn, 'labels_oh': labels,
             'valid_mask': valid}
    return spec, params, model, batch


def test_model_cpg_maps_and_csc_weights_match_jax():
    spec, params, model, batch = csc_fixture()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want_maps, want_idx, want_keep = jax_detector.forward_cpg_maps(
        spec, jp, jb['image'], jb['rois'], jb['obn_scores'],
        jb['valid_mask'], jb['labels_oh'])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    maps, idx, keep = model.forward_cpg_maps(tb)
    assert idx == np.asarray(want_idx).tolist() == [0, 2, -1, -1]
    assert keep.tolist() == np.asarray(want_keep).tolist()
    assert keep.tolist() == [True, True, False, False]
    assert not maps.requires_grad and maps.shape == (4, 48, 48)
    np.testing.assert_allclose(maps.numpy(), np.asarray(want_maps),
                               atol=2e-3)
    out = jax_detector.forward_test(spec, jp, jb['image'], jb['rois'],
                                    jb['obn_scores'], jb['valid_mask'])
    cls_prob = np.asarray(out['rois_pred']).sum(0, keepdims=True)
    flips = ((maps.numpy() >= FG) != (np.asarray(want_maps) >= FG)).sum()
    assert flips <= 3
    want_w, _, _ = jax_cpg.csc_weights(
        want_maps, want_idx, want_keep, jb['rois'], jb['labels_oh'],
        jnp.asarray(cls_prob), fg_threshold=FG, valid_mask=jb['valid_mask'])
    w, _, _ = cpg.csc_weights(
        torch.from_numpy(np.array(want_maps)), idx, keep, tb['rois'],
        tb['labels_oh'], torch.from_numpy(cls_prob), fg_threshold=FG,
        valid_mask=tb['valid_mask'])
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), rtol=1e-5,
                               atol=1e-6)
    assert (w.numpy()[:8, [0, 2]] < 1.0).any()      # real weights
    np.testing.assert_array_equal(w.numpy()[:, [1, 3]], 1.0)
    np.testing.assert_allclose(        # padded RoIs: pred * -1 + (1 - pred)
        w.numpy()[8:, [0, 2]],
        np.broadcast_to(1.0 - 2.0 * cls_prob[:, [0, 2]], (4, 2)), rtol=1e-5)


def test_inactive_seeds_run_no_backward_and_keep_nothing():
    _, _, model, batch = csc_fixture()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    strict = detector.build_model(detector.ModelSpec(
        num_classes=5, hidden_dim=16, webly_on=False, webly_entropy=False,
        box_head='vgg16_2fc', csc=True, cpg=True, cpg_tau=0.7), device='cpu')
    strict.load_state_dict(model.state_dict())
    maps, idx, keep = strict.forward_cpg_maps(tb)   # cls_prob ~ 1/4 < 0.7
    assert idx == [0, 2, -1, -1] and not keep.any() and not maps.any()
