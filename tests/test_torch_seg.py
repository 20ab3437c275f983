"""The port's seg family with the fcn mask head (``SEG_FCN``: the fcn tower
over RoIAlign, its weak loss, mask inference down to RLEs in
detections.pkl) against the JAX package on the CPU: seeded numpy inputs,
bridged weights, dropout off. The deeplab head is in
tests/test_torch_seg_deeplab.py.

Tolerances: the tower at rtol 1e-4, atol 1e-6 (float32 convolutions sum
in another order than XLA's); ``mask_losses`` and the loss ops at rtol
1e-5, atol 1e-6; forward_train's total and aux at rtol 1e-4, atol 1e-5 and
the gradients at rtol 1e-3, atol 1e-5 relative to each leaf's largest
entry (float32 sums over the RoIs in an order that depends on the
machine's GEMM kernels), three chained steps at rtol 1e-3, atol 1e-6 on
the parameters (the bounds of tests/test_torch_train.py); ``forward_masks`` at atol 2e-5 on
probabilities (RoIAlign's coordinate rounding, see
tests/test_torch_roi_align.py, through a sigmoid); the resize against cv2
at atol 1e-5 on values in [0, 1] (cv2 computes its weights in float32 from
a double ratio); ``segm_results`` equal to the JAX package's on the same
masks except where a resized value lies within 1e-5 of the threshold; the
RLE codec exactly equal.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nafwebsod_tpu.core import config as jax_config
from nafwebsod_tpu.engine import test as jax_infer
from nafwebsod_tpu.models import detector as jax_detector
from nafwebsod_tpu.models import seg_head as jax_seg_head
from nafwebsod_tpu.ops import seg as jax_seg
from nafwebsod_tpu.parallel import train_step as jax_ts
from nafwebsod_tpu.solver import sgd as jax_sgd
from nafwebsod_tpu.utils import checkpoint as jax_ckpt
from nafwebsod_tpu.utils import segms as jax_segms
from nafwebsod_torch.core import config as port_config
from nafwebsod_torch.data import task_evaluation
from nafwebsod_torch.engine import test as infer
from nafwebsod_torch.engine import test_engine
from nafwebsod_torch.engine import train as train_engine
from nafwebsod_torch.models import detector, seg_head
from nafwebsod_torch.ops import boxes as box_utils
from nafwebsod_torch.ops import seg as seg_ops
from nafwebsod_torch.parallel import train_step as ts
from nafwebsod_torch.utils import checkpoint, segms
from nafwebsod_torch.utils.bridge import (blob_names, named_blobs,
                                          params_from_jax,
                                          state_to_jax_names)
from nafwebsod_torch.utils.io import load_object

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(num_classes=5, hidden_dim=16, box_head='vgg16_2fc', webly_on=False,
          mask_on=True, mask_head='fcn', mask_resolution=14,
          mask_dim_reduced=8)


@pytest.fixture(autouse=True)
def _fresh_cfgs():
    jax_config.reset_cfg()
    port_config.reset_cfg()
    yield
    jax_config.reset_cfg()
    port_config.reset_cfg()


def _mask_params(rng, num_classes=5, dim_in=16, dim_inner=8, num_convs=2):
    """Asymmetric random mask-head weights and non-zero biases, JAX
    layouts (the package initialises at std 0.001 with zero biases, which
    would hide a mirrored kernel)."""
    params = jax_seg_head.init_mask_head_params(
        jax.random.PRNGKey(0), num_classes, dim_in=dim_in,
        dim_inner=dim_inner, num_convs=num_convs)
    return {k: (rng.randn(*v.shape) * 0.2).astype(np.float32)
            for k, v in params.items()}


def _port_tower(params, num_classes=5, dim_in=16, dim_inner=8, num_convs=2):
    head = seg_head.MaskFcnHead(num_classes, dim_in=dim_in,
                                dim_inner=dim_inner, num_convs=num_convs)
    state = params_from_jax(params)
    head.load_state_dict({k[len('mask_head.'):]: v for k, v in state.items()})
    return head


# --------------------------------------------------------------------------- #
# The tower and its loss
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize('num_convs', [2, 4])
def test_fcn_tower_matches_jax_on_asymmetric_weights(num_convs):
    rng = np.random.RandomState(num_convs)
    params = _mask_params(rng, num_convs=num_convs)
    pooled = rng.randn(6, 14, 14, 16).astype(np.float32)
    want = np.asarray(jax_seg_head.mask_head_from_pooled(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(pooled),
        dilation=2, num_convs=num_convs))
    got = _port_tower(params, num_convs=num_convs)(torch.from_numpy(pooled))
    assert got.shape == (6, 28, 28, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-6)
    assert np.abs(want).max() > 0.01


def test_deconv_takes_the_jax_packages_unflipped_taps():
    """``lax.conv_transpose`` does not flip the kernel; a true transposed
    convolution does: with the taps not reversed every 2x2 output block
    comes out mirrored."""
    rng = np.random.RandomState(1)
    w = rng.randn(2, 2, 3, 5).astype(np.float32)            # HWIO
    x = rng.randn(2, 4, 4, 3).astype(np.float32)
    want = np.asarray(jax.lax.conv_transpose(
        jnp.asarray(x), jnp.asarray(w), strides=(2, 2), padding='VALID',
        dimension_numbers=('NHWC', 'HWIO', 'NHWC')))
    deconv = seg_head.Deconv2x2(3, 5)
    with torch.no_grad():
        deconv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        deconv.bias.zero_()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = deconv(xt).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    mirrored = F.conv_transpose2d(
        xt, deconv.weight.permute(1, 0, 2, 3), stride=2).permute(0, 2, 3, 1)
    assert np.abs(mirrored.detach().numpy() - want).max() > 0.1
    # one tap: input cell (a, b) lands at (2a + 1 - kh, 2b + 1 - kw)
    single = np.zeros((2, 2, 1, 1), np.float32)
    single[0, 1] = 1.0
    deconv = seg_head.Deconv2x2(1, 1)
    with torch.no_grad():
        deconv.weight.copy_(torch.from_numpy(single.transpose(3, 2, 0, 1)))
        deconv.bias.zero_()
    out = deconv(torch.ones(1, 1, 1, 1))[0, 0]
    assert out.tolist() == [[0.0, 0.0], [1.0, 0.0]]


def test_tower_runs_in_float32_under_a_bfloat16_body():
    rng = np.random.RandomState(2)
    params = _mask_params(rng)
    head = _port_tower(params)
    pooled = torch.from_numpy(rng.randn(3, 14, 14, 16).astype(np.float32))
    as_bf16 = pooled.bfloat16()
    out = head(as_bf16)
    assert out.dtype == torch.float32
    assert torch.equal(out, head(as_bf16.float()))
    assert all(p.dtype == torch.float32 for p in head.parameters())


def test_mask_loss_ops_match_jax():
    rng = np.random.RandomState(3)
    logits = (rng.randn(9, 4) * 3).astype(np.float32)
    targets = rng.choice([0.0, 0.5, 1.0], (9, 4)).astype(np.float32)
    weights = rng.rand(9, 4).astype(np.float32)
    want = jax_seg.weighted_sigmoid_cross_entropy_with_logits(
        jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(weights))
    got = seg_ops.weighted_sigmoid_cross_entropy_with_logits(
        torch.from_numpy(logits), torch.from_numpy(targets),
        torch.from_numpy(weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    rois = rng.rand(9, 5).astype(np.float32)
    labels = np.array([[1, 0, 0.5, 1]], np.float32)
    w_j, rois_j, lab_j = jax_seg.mask_utility(
        jnp.asarray(weights), jnp.asarray(rois), jnp.asarray(labels))
    scores = torch.from_numpy(weights).requires_grad_(True)
    w_p, rois_p, lab_p = seg_ops.mask_utility(
        scores, torch.from_numpy(rois), torch.from_numpy(labels))
    assert not w_p.requires_grad
    np.testing.assert_array_equal(w_p.numpy(), np.asarray(w_j))
    np.testing.assert_array_equal(rois_p.numpy(), np.asarray(rois_j))
    np.testing.assert_array_equal(lab_p.numpy(), np.asarray(lab_j))


@pytest.mark.parametrize('with_valid', [True, False])
def test_mask_losses_match_jax(with_valid):
    rng = np.random.RandomState(4)
    mask_logits = (rng.randn(7, 6, 6, 4) * 2).astype(np.float32)
    rois_pred = rng.rand(7, 4).astype(np.float32)
    rois = rng.rand(7, 5).astype(np.float32)
    labels = np.array([[0, 1, 0, 1]], np.float32)
    valid = np.arange(7) < 5 if with_valid else None
    want = jax_seg_head.mask_losses(
        jnp.asarray(mask_logits), jnp.asarray(rois_pred), jnp.asarray(rois),
        jnp.asarray(labels), None if valid is None else jnp.asarray(valid))
    got = seg_head.mask_losses(
        torch.from_numpy(mask_logits), torch.from_numpy(rois_pred),
        torch.from_numpy(rois), torch.from_numpy(labels),
        None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    probs = seg_head.mask_probs_test(torch.from_numpy(mask_logits))
    np.testing.assert_allclose(
        probs.numpy(),
        np.asarray(jax_seg_head.mask_probs_test(jnp.asarray(mask_logits))),
        rtol=1e-6, atol=1e-7)
    assert torch.equal(probs[..., 0], probs[..., 1])


# --------------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------------- #

def _fixture(dtype='float32', seed=0, r=12, padded=3, **kw):
    """(jax spec, jax params as numpy, port model, numpy batch): a 48x56
    image on a 64x64 canvas, padded RoI rows, asymmetric mask weights."""
    kw = dict(KW, **kw)
    spec = jax_detector.ModelSpec(compute_dtype=dtype, **kw)
    params = {k: np.asarray(v) for k, v in jax_detector.init_params(
        spec, jax.random.PRNGKey(seed)).items()}
    rng = np.random.RandomState(seed)
    for k in params:
        if 'mask' in k:
            params[k] = (rng.randn(*params[k].shape) * 0.05).astype(np.float32)
    model = detector.build_model(
        detector.ModelSpec(compute_dtype=dtype, **kw), device='cpu')
    model.load_state_dict(params_from_jax(params))
    h, w = 48, 56
    canvas = np.zeros((1, 64, 64, 3), np.float32)
    canvas[:, :h, :w] = rng.randn(1, h, w, 3) * 8
    x1 = rng.uniform(0, w - 16, r)
    y1 = rng.uniform(0, h - 16, r)
    rois = np.stack([np.zeros(r), x1, y1,
                     np.minimum(x1 + rng.uniform(8, 30, r), w - 1),
                     np.minimum(y1 + rng.uniform(8, 30, r), h - 1)],
                    1).astype(np.float32)
    valid = np.arange(r) < r - padded
    rois[~valid] = 0
    obn = rng.uniform(0.5, 1.5, (r, 1)).astype(np.float32)
    obn[~valid] = 0
    labels = np.zeros((1, 4), np.float32)
    labels[0, [1, 3]] = 1
    batch = {'image': canvas, 'rois': rois, 'obn_scores': obn,
             'labels_oh': labels, 'valid_mask': valid}
    return spec, params, model, batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_fcn_model_has_the_reference_blobs():
    _, params, model, _ = _fixture()
    names = blob_names(model)
    assert set(names) == set(model.state_dict())
    assert set(names.values()) == set(params)
    for blob in ('_[mask]_fcn1_w', '_[mask]_fcn2_b', 'conv5_mask_w',
                 'mask_fcn_logits_b'):
        assert blob in params
    assert model.mask_head.conv5_mask.weight.shape == (8, 8, 2, 2)


def test_forward_train_total_aux_and_gradients_match_jax():
    spec, params, model, batch = _fixture()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    (want, want_aux), want_grads = jax.value_and_grad(
        lambda p: jax_detector.forward_train(spec, p, _jax(batch), None),
        has_aux=True)(jp)
    total, aux = model.forward_train(_port(batch))
    assert set(aux) == set(want_aux) == {'loss_cls', 'accuracy_cls',
                                         'mask_loss_cls'}
    np.testing.assert_allclose(total.item(), float(want), rtol=1e-4,
                               atol=1e-5)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(want_aux[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert aux['mask_loss_cls'].item() > 1e-3
    blobs = named_blobs(model)
    names = [n for n in blobs if not n.startswith('conv') or 'mask' in n]
    grads = torch.autograd.grad(total, [blobs[n] for n in names])
    got = state_to_jax_names(dict(zip(names, grads)))
    for n in names:
        ref = np.asarray(want_grads[n])
        # a weight gradient is a float32 sum of the products of the 2048
        # RoIs, taken in an order that depends on the machine's GEMM
        # kernels (and XLA's): such sums differ by a few units of 1e-6 of
        # the leaf's largest entry, so the floor is 1e-5 of it
        np.testing.assert_allclose(got[n], ref, rtol=1e-3,
                                   atol=1e-5 * max(np.abs(ref).max(), 1.0),
                                   err_msg=n)
        if 'mask' in n:
            assert np.abs(ref).max() > 0, n
    # the detection scores weigh the mask loss as constants: the box head's
    # gradient is that of loss_cls alone
    only_cls = torch.autograd.grad(
        model.forward_train(_port(batch))[1]['loss_cls'],
        blobs['fc8d_w'])[0]
    assert torch.equal(only_cls, grads[names.index('fc8d_w')])
    for n in blobs:
        if n.startswith('conv') and 'mask' not in n:
            assert not np.asarray(want_grads[n]).any(), n


def test_padded_rows_give_finite_masks_and_no_loss():
    _, _, model, batch = _fixture()
    pb = _port(batch)
    feat, _ = model.body_forward(pb['image'])
    pooled = model._mask_pooled(feat, pb['rois'])
    assert pooled.dtype == torch.float32 and torch.isfinite(pooled).all()
    total, _ = model.forward_train(pb)
    moved = dict(pb, rois=pb['rois'].clone())
    moved['rois'][~pb['valid_mask'], 1:] = torch.tensor([3.0, 4, 30, 40])
    assert model.forward_train(moved)[1]['mask_loss_cls'].item() == \
        model.forward_train(pb)[1]['mask_loss_cls'].item()
    assert torch.isfinite(total)


def test_three_train_steps_track_jax():
    spec, params, model, batch = _fixture()
    trainable = jax_detector.trainable_param_names(spec, params)
    hp_j = jax_sgd.SGDHyperParams()
    raw_mults_j = jax_sgd.param_multipliers(params, trainable)
    mults_j = jax_sgd.freeze_mults(raw_mults_j)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state_j = jax_sgd.init_state(jp, hp_j)
    stacked = {k: jnp.asarray(v)[None] for k, v in batch.items()}
    stacked['cur_iter'] = jnp.zeros((1,), jnp.float32)

    port_config.cfg.SOLVER.MOMENTUM = 0.9
    hp, mults, state = train_engine.create_solver(model)
    assert {n for n, m in mults.items() if m != (0.0, 0.0)} == trainable
    # the solver's rules reach the new leaves: a bias takes twice the
    # learning rate and no decay, conv5_mask's among them
    for n in ('conv5_mask_b', '_[mask]_fcn1_b', 'mask_fcn_logits_b'):
        assert mults[n] == (2.0, 0.0) == tuple(raw_mults_j[n]), n
    for n in ('conv5_mask_w', '_[mask]_fcn2_w', 'mask_fcn_logits_w'):
        assert mults[n] == (1.0, 1.0) == tuple(raw_mults_j[n]), n
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
        if n.startswith('conv') and 'mask' not in n:
            np.testing.assert_array_equal(got[n], params[n])
    for n in ('fc6_w', '_[mask]_fcn1_w', 'conv5_mask_w', 'conv5_mask_b',
              'mask_fcn_logits_w'):
        assert (got[n] != params[n]).any(), n


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_forward_masks_matches_jax(dtype):
    spec, params, model, batch = _fixture(dtype)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    rois = batch['rois'][:9]
    want = np.asarray(jax_detector.forward_masks(
        spec, jp, jnp.asarray(batch['image']), jnp.asarray(rois)))
    got = model.forward_masks(torch.from_numpy(batch['image']),
                              torch.from_numpy(rois))
    assert got.shape == (9, 28, 28, 5) and got.dtype == torch.float32
    assert not got.requires_grad
    # bfloat16: the two frameworks round the body's 13 layers at other
    # places; the tower itself is float32 on both sides
    tol = 2e-5 if dtype == 'float32' else 2e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    assert np.ptp(want) > 1e-3


def test_unported_mask_options_raise_by_name():
    cfg = port_config.cfg
    port_config.merge_cfg_from_cfg(port_config.SEG_FCN)
    detector.spec_from_cfg(cfg)
    for name in ('mask_rcnn_fcn_head_v0up', 'mask_rcnn_fcn_head_v0upshare',
                 'mask_rcnn_fcn_head_v1up4convs_gn'):
        cfg.MRCNN.ROI_MASK_HEAD = 'mask_rcnn_heads.' + name
        with pytest.raises(NotImplementedError, match=name):
            detector.spec_from_cfg(cfg)
    cfg.MRCNN.ROI_MASK_HEAD = 'wsl_seg_heads.mask_rcnn_fcn_head'
    cfg.TRAIN.FREEZE_CONV_BODY = False
    with pytest.raises(NotImplementedError, match='K4 backward'):
        detector.spec_from_cfg(cfg)
    cfg.TRAIN.FREEZE_CONV_BODY = True
    cfg.MODEL.FASTER_RCNN = True
    with pytest.raises(NotImplementedError, match='FASTER_RCNN'):
        detector.spec_from_cfg(cfg)
    cfg.MODEL.FASTER_RCNN = False
    cfg.TEST.MASK_AUG.ENABLED = True
    with pytest.raises(NotImplementedError, match='MASK_AUG'):
        infer.check_protocol()


def test_roi_align_as_the_box_transform_matches_jax():
    kw = dict(num_classes=5, hidden_dim=16, box_head='vgg16_2fc',
              webly_on=False, roi_xform_method='RoIAlign')
    spec = jax_detector.ModelSpec(**kw)
    params = {k: np.asarray(v) for k, v in jax_detector.init_params(
        spec, jax.random.PRNGKey(2)).items()}
    model = detector.build_model(detector.ModelSpec(**kw), device='cpu')
    model.load_state_dict(params_from_jax(params))
    _, _, _, batch = _fixture()
    jb, pb = _jax(batch), _port(batch)
    want = jax_detector.forward_test(
        spec, {k: jnp.asarray(v) for k, v in params.items()}, jb['image'],
        jb['rois'], jb['obn_scores'], jb['valid_mask'])
    got = model.forward_test(pb['image'], pb['rois'], pb['obn_scores'],
                             pb['valid_mask'])
    np.testing.assert_allclose(got['scores'].numpy(),
                               np.asarray(want['scores']), rtol=1e-4,
                               atol=1e-5)
    pool = detector.build_model(detector.ModelSpec(
        **dict(kw, roi_xform_method='RoIPoolF')), device='cpu')
    pool.load_state_dict(params_from_jax(params))
    assert not torch.equal(pool.forward_test(
        pb['image'], pb['rois'], pb['obn_scores'],
        pb['valid_mask'])['scores'], got['scores'])
    # the cfg's key reaches the spec; what has no gradient yet is refused
    cfg = port_config.cfg
    port_config.merge_cfg_from_cfg(port_config.CSC)
    cfg.WSL.CSC = cfg.WSL.CPG = False
    cfg.FAST_RCNN.ROI_XFORM_METHOD = 'RoIAlign'
    spec_p = detector.spec_from_cfg(cfg)
    assert (spec_p.roi_xform_method, spec_p.roi_sampling_ratio) == (
        'RoIAlign', 2)
    cfg.TRAIN.FREEZE_CONV_BODY = False
    with pytest.raises(NotImplementedError, match='RoIAlign'):
        detector.spec_from_cfg(cfg)
    cfg.TRAIN.FREEZE_CONV_BODY = True
    cfg.WSL.CSC = cfg.WSL.CPG = True
    with pytest.raises(NotImplementedError, match='RoIAlign'):
        detector.spec_from_cfg(cfg)


# --------------------------------------------------------------------------- #
# Config and checkpoints
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


def test_seg_dict_equals_the_yaml():
    pytest.importorskip('yaml')
    port_config.merge_cfg_from_file(os.path.join(
        REPO, 'configs', 'wsod_families', 'seg_V-16-C5.yaml'))
    from_yaml = dict(port_config.cfg)
    port_config.reset_cfg()
    port_config.merge_cfg_from_cfg(port_config.SEG)
    _same(from_yaml, dict(port_config.cfg))
    spec = detector.spec_from_cfg(port_config.cfg)
    assert spec.is_deeplab and spec.cpg and not spec.csc
    assert spec.cpg_tau == 0.7 and spec.max_gt_cpg == 4
    assert spec.compute_dtype == 'bfloat16'


def test_seg_fcn_changes_three_keys_and_agrees_with_the_jax_spec():
    port_config.merge_cfg_from_cfg(port_config.SEG)
    seg = dict(port_config.cfg)
    port_config.reset_cfg()
    port_config.merge_cfg_from_cfg(port_config.SEG_FCN)
    fcn = dict(port_config.cfg)
    diff = {k for k in fcn['MRCNN'] if fcn['MRCNN'][k] != seg['MRCNN'][k]}
    assert diff == {'ROI_MASK_HEAD', 'ROI_XFORM_RESOLUTION'}
    assert fcn['MRCNN']['RESOLUTION'] == seg['MRCNN']['RESOLUTION'] == 28
    assert fcn['MRCNN']['ROI_XFORM_RESOLUTION'] == 14
    for k in fcn:
        if k != 'MRCNN':
            _same(fcn[k], seg[k], k)
    jax_config.merge_cfg_from_cfg(port_config.SEG_FCN)
    want = jax_detector.spec_from_cfg(jax_config.cfg)
    assert (want.mask_head, want.mask_num_convs, want.mask_resolution) == (
        'fcn', 2, 14)
    got = detector.spec_from_cfg(port_config.cfg)
    for field in got.__dataclass_fields__:
        assert getattr(got, field) == getattr(want, field), field
    assert got.mask_dim_reduced == 256 and got.mask_dilation == 2
    assert port_config.cfg.MRCNN.THRESH_BINARIZE == 0.5
    # '' is the same head
    port_config.cfg.MRCNN.ROI_MASK_HEAD = ''
    assert detector.spec_from_cfg(port_config.cfg) == got


def test_fcn_pkl_round_trip_is_bitwise(tmp_path):
    _, params, model, _ = _fixture()
    jax_pkl = str(tmp_path / 'jax.pkl')
    jax_ckpt.save_params_to_weights_file(jax_pkl, params)
    fresh = detector.build_model(detector.ModelSpec(**KW), device='cpu',
                                 seed=5)
    assert checkpoint.initialize_from_weights_file(fresh, jax_pkl) == []
    for key, value in model.state_dict().items():
        assert torch.equal(value, fresh.state_dict()[key]), key
    port_pkl = str(tmp_path / 'port.pkl')
    checkpoint.save_weights_file(port_pkl, fresh)
    a, _ = checkpoint.load_weights_pkl(jax_pkl)
    b, _ = checkpoint.load_weights_pkl(port_pkl)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the JAX loader reads the port's file back to the same parameters
    template = {k: np.zeros_like(v) for k, v in params.items()}
    back, _, unmatched = jax_ckpt.initialize_params_from_weights_file(
        template, port_pkl)
    assert unmatched == []
    for k in params:
        np.testing.assert_array_equal(np.asarray(back[k]), params[k],
                                      err_msg=k)


def test_seeded_init_of_the_mask_head():
    a = detector.build_model(detector.ModelSpec(**KW), device='cpu', seed=3)
    b = detector.build_model(detector.ModelSpec(**KW), device='cpu', seed=3)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.mask_head.fcn1.weight
    assert abs(w.std().item() - 0.001) < 1e-4
    assert not a.mask_head.conv5_mask.bias.any()


# --------------------------------------------------------------------------- #
# Mask inference on the host: resize, paste, RLE
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize('src,dst', [
    ((30, 30), (57, 41)), ((30, 30), (11, 23)), ((30, 30), (30, 30)),
    ((16, 16), (1, 1)), ((30, 30), (200, 3)), ((7, 9), (64, 48))])
def test_resize_matches_cv2(src, dst):
    rng = np.random.RandomState(sum(src) + sum(dst))
    a = rng.rand(*src).astype(np.float32)
    want = cv2.resize(a, (dst[1], dst[0]))
    got = infer.resize_bilinear(a, dst[0], dst[1])
    assert got.shape == dst and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_rle_codec_equals_the_jax_packages():
    rng = np.random.RandomState(0)
    masks = [(rng.rand(13, 17) > 0.5), (rng.rand(40, 31) > 0.9),
             np.zeros((4, 5)), np.ones((4, 5)), np.ones((1, 1)),
             np.tril(np.ones((300, 300)))]
    for m in masks:
        m = m.astype(np.uint8)
        rle = segms.mask_to_rle(m)
        assert rle == jax_segms.mask_to_rle(m)
        np.testing.assert_array_equal(segms.rle_to_mask(rle), m)
        np.testing.assert_array_equal(jax_segms.rle_to_mask(rle), m)
        as_str = dict(rle, counts=rle['counts'].decode('ascii'))
        np.testing.assert_array_equal(segms.rle_to_mask(as_str), m)
    assert segms.mask_to_rle(np.array([[0, 1], [1, 1]], np.uint8))[
        'counts'] == jax_segms.mask_to_rle(
            np.array([[0, 1], [1, 1]], np.uint8))['counts']
    a, b = masks[0], masks[0].T[:13, :13]
    assert segms.mask_iou(masks[0], masks[0]) == 1.0
    assert segms.mask_iou(masks[2], masks[2]) == 0.0
    assert segms.mask_iou(a[:13, :13], b) == jax_segms.mask_iou(a[:13, :13],
                                                                 b)


def test_expand_boxes_equals_the_jax_packages():
    from nafwebsod_tpu.ops import boxes as jax_boxes
    boxes = np.array([[4, 4, 24, 24], [0, 0, 3, 90], [10.5, 8, 30, 28.25]],
                     np.float32)
    np.testing.assert_array_equal(box_utils.expand_boxes(boxes, 16 / 14),
                                  jax_boxes.expand_boxes(boxes, 16 / 14))


def _cls_boxes(rng, counts, im_h, im_w):
    cls_boxes = [[]]
    for n in counts:
        x1 = rng.uniform(-4, im_w - 10, n)
        y1 = rng.uniform(-4, im_h - 10, n)
        d = np.stack([x1, y1, x1 + rng.uniform(3, 40, n),
                      y1 + rng.uniform(3, 40, n), rng.rand(n)], 1)
        cls_boxes.append(d.astype(np.float32))
    return cls_boxes


@pytest.mark.parametrize('cls_specific', [True, False])
def test_segm_results_equal_the_jax_packages_on_the_same_masks(cls_specific):
    rng = np.random.RandomState(5)
    for c in (jax_config.cfg, port_config.cfg):
        c.MODEL.NUM_CLASSES = 5
        c.MRCNN.CLS_SPECIFIC_MASK = cls_specific
    cls_boxes = _cls_boxes(rng, [2, 0, 3, 1], 60, 70)
    boxes, counts = infer._final_boxes(cls_boxes)
    assert counts == [2, 0, 3, 1] and boxes.shape == (6, 4)
    np.testing.assert_array_equal(boxes, jax_infer._final_boxes(cls_boxes)[0])
    # smooth soft masks: blobs around 0.5
    yy, xx = np.mgrid[0:28, 0:28]
    masks = np.stack([
        np.stack([1 / (1 + np.exp(((yy - cy) ** 2 + (xx - cx) ** 2 - r2) / 30))
                  for cy, cx, r2 in rng.uniform(5, 23, (5, 3)) * [1, 1, 6]],
                 -1) for _ in range(6)]).astype(np.float32)
    got = infer.segm_results(cls_boxes, masks, boxes, 60, 70)
    want = jax_infer.segm_results(cls_boxes, masks, boxes, 60, 70)
    assert [len(s) for s in got] == [0, 2, 0, 3, 1]
    differing = 0
    for j in range(5):
        for g, w in zip(got[j], want[j]):
            assert g['size'] == w['size'] == [60, 70]
            differing += int((segms.rle_to_mask(g)
                              != segms.rle_to_mask(w)).sum())
            assert segms.rle_to_mask(g).any()
    # a pixel may differ only where cv2's value is within 1e-5 of 0.5
    assert differing <= 2


def test_each_mask_lies_inside_its_expanded_box_and_the_image():
    rng = np.random.RandomState(6)
    port_config.cfg.MODEL.NUM_CLASSES = 3
    cls_boxes = [[], np.array([[-6, 40, 30, 70, 0.9]], np.float32),
                 np.array([[50, 10, 90, 30, 0.8]], np.float32)]
    boxes, _ = infer._final_boxes(cls_boxes)
    masks = np.ones((2, 28, 28, 3), np.float32)
    out = infer.segm_results(cls_boxes, masks, boxes, 60, 80)
    expanded = box_utils.expand_boxes(boxes, 30 / 28).astype(np.int32)
    for rle, box in zip([out[1][0], out[2][0]], expanded):
        m = segms.rle_to_mask(rle)
        ys, xs = np.nonzero(m)
        assert m.shape == (60, 80) and len(ys)
        assert xs.min() >= max(box[0], 0) and xs.max() <= min(box[2], 79)
        assert ys.min() >= max(box[1], 0) and ys.max() <= min(box[3], 59)
    assert rng is not None


def _tiny_cfg(config):
    """SEG_FCN at a narrow width, float32."""
    config.merge_cfg_from_cfg(port_config.SEG_FCN)
    c = config.cfg
    c.MODEL.NUM_CLASSES = 5
    c.MRCNN.DIM_REDUCED = 8
    c.TPU.HEAD_HIDDEN_DIM = 16
    c.TPU.COMPUTE_DTYPE = 'float32'
    c.TEST.SCALE = 64
    c.TEST.MAX_SIZE = 96
    c.TEST.DETECTIONS_PER_IM = 6
    c.TEST.SCORE_THRESH = 1e-9
    c.DEDUP_BOXES = 0.125


def _image_and_proposals(rng, h=48, w=60, r=20):
    im = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    x1 = rng.uniform(0, w - 12, r)
    y1 = rng.uniform(0, h - 12, r)
    boxes = np.round(np.stack(
        [x1, y1, np.minimum(x1 + rng.uniform(8, 40, r), w - 1),
         np.minimum(y1 + rng.uniform(8, 30, r), h - 1)], 1)).astype(
             np.float32)
    return im, boxes, rng.rand(r, 1).astype(np.float32)


def test_im_detect_all_returns_the_jax_packages_masks():
    _tiny_cfg(jax_config)
    _tiny_cfg(port_config)
    spec = jax_detector.spec_from_cfg(jax_config.cfg)
    params = {k: np.asarray(v) for k, v in jax_detector.init_params(
        spec, jax.random.PRNGKey(3)).items()}
    rng = np.random.RandomState(7)
    for k in params:
        if 'mask' in k:
            params[k] = (rng.randn(*params[k].shape) * 0.1).astype(np.float32)
    model = test_engine.initialize_model_from_cfg(device='cpu')
    model.load_state_dict(params_from_jax(params))
    im, boxes, obn = _image_and_proposals(rng)
    want_boxes, want_segms, _ = jax_infer.im_detect_all(
        spec, {k: jnp.asarray(v) for k, v in params.items()}, im, boxes, obn)
    cls_boxes, cls_segms, cls_keyps = infer.im_detect_all(model, im, boxes,
                                                          obn)
    assert cls_keyps is None and len(cls_segms) == 5
    n_dets = 0
    for j in range(1, 5):
        np.testing.assert_allclose(cls_boxes[j], want_boxes[j], rtol=1e-4,
                                   atol=1e-6)
        assert len(cls_segms[j]) == len(cls_boxes[j]) == len(want_segms[j])
        for g, w in zip(cls_segms[j], want_segms[j]):
            a, b = segms.rle_to_mask(g), segms.rle_to_mask(w)
            assert a.shape == im.shape[:2]
            # soft masks agree to 2e-5: a pixel flips only at the threshold
            assert (a != b).mean() < 0.002
            n_dets += 1
    assert 0 < n_dets <= 6
    masks = infer.im_detect_mask(model, im, cls_boxes)
    assert [len(m) for m in masks] == [len(m) for m in cls_segms]
    empty = [[]] + [np.zeros((0, 5), np.float32)] * 4
    assert infer.im_detect_mask(model, im, empty) == [[]] * 5


def test_test_net_writes_the_rles_and_segm_scoring_raises(tmp_path):
    pytest.importorskip('yaml')
    _tiny_cfg(port_config)
    model = test_engine.initialize_model_from_cfg(device='cpu')
    rng = np.random.RandomState(8)
    roidb = []
    for i in range(2):
        im, boxes, obn = _image_and_proposals(rng)
        roidb.append({'image': im, 'id': 10 + i, 'boxes': boxes,
                      'obn_scores': obn})
    roidb.append({'image': im, 'id': 12, 'boxes': np.zeros((0, 4), np.float32),
                  'obn_scores': np.zeros((0, 1), np.float32)})
    all_boxes, all_segms, all_keyps = test_engine.test_net(
        model, roidb, output_dir=str(tmp_path))
    assert all_keyps is None
    saved = load_object(str(tmp_path / 'detections.pkl'))
    assert saved['image_ids'] == [10, 11, 12]
    assert len(saved['all_segms']) == 5
    for j in range(1, 5):
        for i in range(2):
            assert len(saved['all_segms'][j][i]) == len(all_boxes[j][i])
            for rle, got in zip(saved['all_segms'][j][i], all_segms[j][i]):
                assert rle == got and rle['size'] == [48, 60]
        assert saved['all_segms'][j][2] == []
    assert sum(len(all_segms[j][0]) for j in range(1, 5)) > 0
    with pytest.raises(NotImplementedError, match='evaluate_masks'):
        task_evaluation.evaluate_all(None, all_boxes, all_segms, None,
                                     str(tmp_path))
