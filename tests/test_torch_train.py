"""The port's training slice (forward_train, the solver, the train step,
minibatches, checkpoints with momentum, the training loop) against the JAX
package on the CPU: bridged weights, seeded numpy inputs, float32, no
dropout unless a test is about dropout.

Tolerances: forward_train's total and aux at rtol 1e-4, atol 1e-5 (the
bound of the forward tests); gradients of the trainable leaves at
rtol 1e-3, atol 1e-5 of each leaf's largest entry (float32 sums over the
RoIs in an order that depends on the machine's GEMM kernels); one solver
update on identical gradients at
rtol 1e-6 (the same three float32 operations, possibly contracted
differently); three chained steps at rtol 1e-3, atol 1e-6 on the
parameters (the gradients' differences reach them times the learning rate,
1e-3) and rtol 1e-4 on the losses; numpy blobs bitwise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafwebsod_tpu.core import config as jax_config
from nafwebsod_tpu.data import minibatch as jax_minibatch
from nafwebsod_tpu.models import detector as jax_detector
from nafwebsod_tpu.parallel import train_step as jax_ts
from nafwebsod_tpu.solver import sgd as jax_sgd
from nafwebsod_tpu.utils import checkpoint as jax_ckpt
from nafwebsod_tpu.utils import lr_policy as jax_lr_policy
from nafwebsod_torch.core import config as port_config
from nafwebsod_torch.data import loader, minibatch
from nafwebsod_torch.engine import test_engine
from nafwebsod_torch.engine import train as train_engine
from nafwebsod_torch.models import detector, heads
from nafwebsod_torch.parallel import train_step as ts
from nafwebsod_torch.solver import sgd
from nafwebsod_torch.utils import checkpoint, lr_policy
from nafwebsod_torch.utils.bridge import (blob_names, named_blobs,
                                          params_from_jax,
                                          state_to_jax_names)

from test_torch_cpg import csc_fixture


@pytest.fixture(autouse=True)
def _fresh_cfgs():
    jax_config.reset_cfg()
    port_config.reset_cfg()
    yield
    jax_config.reset_cfg()
    port_config.reset_cfg()


def _fixture(family, seed=1):
    """(jax spec, jax params as numpy, port model, numpy batch)."""
    if family == 'csc':
        return csc_fixture(seed=seed)
    _, _, _, batch = csc_fixture(seed=seed)
    kw = (dict(webly_on=True, webly_entropy=True,
               box_head='vgg16_2fc_noise') if family == 'flagship' else
          dict(webly_on=False, webly_entropy=False, box_head='vgg16_2fc'))
    spec = jax_detector.ModelSpec(num_classes=5, hidden_dim=16,
                                  compute_dtype='float32', **kw)
    params = {k: np.asarray(v) for k, v in jax_detector.init_params(
        spec, jax.random.PRNGKey(seed)).items()}
    model = detector.build_model(
        detector.ModelSpec(num_classes=5, hidden_dim=16, **kw), device='cpu')
    model.load_state_dict(params_from_jax(params))
    if family == 'flagship':
        batch['labels_oh'] = np.array([[0.7, 0, 0.3, 0]], np.float32)
    return spec, params, model, batch


def _jax_batch(batch, cur_iter=0.0):
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    out['cur_iter'] = jnp.asarray(cur_iter, jnp.float32)
    return out


def _port_batch(batch, cur_iter=0.0):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out['cur_iter'] = cur_iter
    return out


AUX_KEYS = {
    'flagship': {'loss_cls', 'loss_cls_noise', 'accuracy_cls',
                 'accuracy_cls_noise', 'class_weight_mean',
                 'class_weight_noise_mean'},
    'csc': {'loss_cls_pos', 'loss_cls_neg', 'accuracy_cls'},
    'plain': {'loss_cls', 'accuracy_cls'},
}


@pytest.mark.parametrize('family', ['flagship', 'csc', 'plain'])
def test_forward_train_total_aux_and_gradients_match_jax(family):
    spec, params, model, batch = _fixture(family)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    (want, want_aux), want_grads = jax.value_and_grad(
        lambda p: jax_detector.forward_train(spec, p, _jax_batch(batch),
                                             None), has_aux=True)(jp)
    total, aux = model.forward_train(_port_batch(batch))
    assert set(aux) == set(want_aux) == AUX_KEYS[family]
    np.testing.assert_allclose(total.item(), float(want), rtol=1e-4,
                               atol=1e-5)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(want_aux[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    blobs = named_blobs(model)
    names = [n for n in blobs if not n.startswith('conv')]
    grads = torch.autograd.grad(total, [blobs[n] for n in names])
    got = state_to_jax_names(dict(zip(names, grads)))
    assert float(np.abs(got['fc8c_w']).max()) > 0
    for n in names:
        ref = np.asarray(want_grads[n])
        # a weight gradient is a float32 sum of the products of the RoIs,
        # taken in an order that depends on the machine's GEMM kernels (and
        # XLA's): the floor is 1e-5 of the leaf's largest entry
        np.testing.assert_allclose(got[n], ref, rtol=1e-3,
                                   atol=1e-5 * max(np.abs(ref).max(), 1.0),
                                   err_msg=n)
    for n in blobs:                       # the frozen body got no gradient
        if n.startswith('conv'):
            assert not np.asarray(want_grads[n]).any(), n


def test_csc_past_max_iter_reduces_to_plain_ce():
    spec, params, model, batch = _fixture('csc')
    _, _, plain, _ = _fixture('plain')
    plain.load_state_dict(model.state_dict())
    late = float(model.spec.csc_max_iter + 5)
    total, aux = model.forward_train(_port_batch(batch, late))
    _, aux_plain = plain.forward_train(_port_batch(batch, late))
    assert aux['loss_cls_neg'].item() == pytest.approx(0.0, abs=1e-6)
    assert aux['loss_cls_pos'].item() == pytest.approx(
        aux_plain['loss_cls'].item(), rel=1e-6)
    want, _ = jax_detector.forward_train(
        spec, {k: jnp.asarray(v) for k, v in params.items()},
        _jax_batch(batch, late), None)
    np.testing.assert_allclose(total.item(), float(want), rtol=1e-4)
    early, _ = model.forward_train(_port_batch(batch, 0.0))
    assert early.item() != pytest.approx(total.item(), rel=1e-4)


def _random_tree(params, seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*np.shape(v)).astype(np.float32) * 0.01
            for k, v in params.items()}


@pytest.mark.parametrize('iter_size', [1, 2])
def test_sgd_update_matches_jax_leaf_by_leaf(iter_size):
    spec, params, model, _ = _fixture('flagship')
    # a name with the 10x learning-rate infix, on both sides
    params = dict(params, fc8c_lrm10_w=params['fc8c_w'] * 0.5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    trainable = {n for n in params if not n.startswith('conv')}
    hp_j = jax_sgd.SGDHyperParams(momentum=0.9, weight_decay=0.0005,
                                  iter_size=iter_size)
    mults_j = jax_sgd.param_multipliers(params, trainable)
    state_j = jax_sgd.init_state(jp, hp_j)

    blobs = dict(named_blobs(model))
    blobs['fc8c_lrm10_w'] = (blobs['fc8c_w'].detach() * 0.5).clone()
    hp = sgd.SGDHyperParams(momentum=0.9, weight_decay=0.0005,
                            iter_size=iter_size)
    mults = sgd.param_multipliers(blobs, trainable)
    assert mults == mults_j
    assert mults['fc6_b'] == (2.0, 0.0) and mults['fc6_w'] == (1.0, 1.0)
    assert mults['fc8c_lrm10_w'] == (10.0, 1.0)
    assert mults['conv1_1_w'] == (0.0, 0.0)
    state = sgd.init_state(blobs, hp, mults)
    body_before = blobs['conv3_1_w'].detach().clone()

    for step in range(2 * iter_size + 1):
        lr = np.float32(0.01 / (step + 1))
        grads = _random_tree(params, step)
        jp, state_j = jax_sgd.update(
            jp, {k: jnp.asarray(v) for k, v in grads.items()}, state_j, lr,
            hp_j, jax_sgd.freeze_mults(mults_j))
        port_grads = params_from_jax(grads)
        by_blob = {blob: port_grads[key]
                   for key, blob in blob_names().items()}
        by_blob['fc8c_lrm10_w'] = torch.from_numpy(
            np.ascontiguousarray(grads['fc8c_lrm10_w'].T))
        sgd.update(blobs, {k: v for k, v in by_blob.items()
                           if k in trainable}, state, lr, hp, mults)
        assert state['it'] == int(state_j['it']) == step + 1
        got_p = state_to_jax_names(blobs)
        got_m = state_to_jax_names(state['momentum'])
        for n in params:
            np.testing.assert_allclose(got_p[n], np.asarray(jp[n]),
                                       rtol=1e-6, atol=1e-9, err_msg=n)
            np.testing.assert_allclose(
                got_m[n], np.asarray(state_j['momentum'][n]), rtol=1e-6,
                atol=1e-9, err_msg=n)
    assert torch.equal(blobs['conv3_1_w'], body_before)
    assert not state['momentum']['conv3_1_w'].any()
    assert state['momentum']['fc6_w'].any()


def test_scale_momentum_and_correction_factor_match_jax():
    _, params, model, _ = _fixture('plain')
    blobs = named_blobs(model)
    hp = sgd.SGDHyperParams()
    state = sgd.init_state(blobs, hp)
    mom = _random_tree(params, 5)
    for key, value in params_from_jax(mom).items():
        state['momentum'][blob_names()[key]].copy_(value)
    state_j = {'momentum': {k: jnp.asarray(v) for k, v in mom.items()},
               'it': jnp.zeros((), jnp.int32)}
    state_j = jax_sgd.scale_momentum(state_j, np.float32(0.1))
    sgd.scale_momentum(state, np.float32(0.1))
    got = state_to_jax_names(state['momentum'])
    for n in mom:
        np.testing.assert_allclose(got[n],
                                   np.asarray(state_j['momentum'][n]),
                                   rtol=1e-6)
    for new, old in [(0.001, 0.001), (0.0001, 0.001), (0.00105, 0.001),
                     (0.001, 0.0), (0.002, 0.001)]:
        assert sgd.momentum_correction_factor(
            port_config.cfg, np.float32(new), np.float32(old)) == \
            jax_sgd.momentum_correction_factor(
                jax_config.cfg, np.float32(new), np.float32(old))


def test_lr_policy_matches_jax():
    for c in (jax_config.cfg, port_config.cfg):
        c.SOLVER.BASE_LR = 0.01
        c.SOLVER.STEPS = [0, 10, 20]
        c.SOLVER.WARM_UP_ITERS = 5
        c.SOLVER.MAX_ITER = 30
    for policy in ('steps_with_decay', 'step', 'cosine_decay', 'exp_decay'):
        jax_config.cfg.SOLVER.LR_POLICY = policy
        port_config.cfg.SOLVER.LR_POLICY = policy
        for it in (0, 3, 5, 10, 19, 20, 29):
            got = lr_policy.get_lr_at_iter(it)
            assert got.dtype == np.float32
            assert got == jax_lr_policy.get_lr_at_iter(it), (policy, it)


@pytest.mark.parametrize('family', ['flagship', 'csc'])
def test_three_train_steps_track_jax(family):
    spec, params, model, batch = _fixture(family)
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
        loss, aux = ts.train_step(model, state, _port_batch(batch), lr,
                                  None, hp=hp, mults=mults)
        assert not loss.requires_grad and set(aux) == AUX_KEYS[family]
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4,
                                   atol=1e-5, err_msg=str(step))
    got = state_to_jax_names(named_blobs(model))
    moved = 0
    for n in params:
        # the gradients' differences (see the test above) reach the
        # parameters times the learning rate, 1e-3
        np.testing.assert_allclose(got[n], np.asarray(jp[n]), rtol=1e-3,
                                   atol=1e-6, err_msg=n)
        if n.startswith('conv'):
            np.testing.assert_array_equal(got[n], params[n])
        else:
            moved += int((got[n] != params[n]).any())
    assert moved == len(trainable)


def test_dropout_repeats_its_masks_from_one_seed():
    x = torch.ones(64, 32)
    gen = torch.Generator().manual_seed(3)
    a = heads.dropout(x, 0.5, gen, True)
    b = heads.dropout(x, 0.5, gen, True)
    gen.manual_seed(3)
    assert torch.equal(heads.dropout(x, 0.5, gen, True), a)
    assert not torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert 0.4 < (a == 0).float().mean() < 0.6
    assert heads.dropout(x, 0.5, None, True) is x
    assert heads.dropout(x, 0.5, gen, False) is x
    # the same seed gives the same training loss; another seed another one
    _, _, model, batch = _fixture('flagship')
    losses = []
    for seed in (7, 7, 8):
        gen.manual_seed(seed)
        losses.append(model.forward_train(_port_batch(batch), gen)[0].item())
    assert losses[0] == losses[1] != losses[2]


def _entry(rng, h=60, w=80, n=30, classes=(2, 4)):
    boxes = rng.uniform(0, 40, (n, 4)).astype(np.float32)
    boxes[:, 2:] = np.minimum(boxes[:, :2] + 5 + rng.uniform(0, 30, (n, 2)),
                              [w - 1, h - 1])
    gt = np.zeros(n + len(classes), np.int32)
    gt[:len(classes)] = classes
    return {'image': rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
            'width': w, 'height': h,
            'boxes': np.vstack([boxes[:len(classes)], boxes]),
            'obn_scores': rng.rand(n + len(classes), 1).astype(np.float32),
            'gt_classes': gt, 'id': 7}


def _same_blobs(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize('pad_to', [None, 48, 16])
def test_sample_rois_is_bitwise_the_jax_packages(pad_to):
    entry = _entry(np.random.RandomState(0))
    crop = np.array([3, 5, 50, 70], np.int32)
    _same_blobs(
        minibatch.sample_rois(entry, 1.7, crop, 5, 24, pad_to=pad_to),
        jax_minibatch.sample_rois(entry, 1.7, crop, 5, 24, pad_to=pad_to))


@pytest.mark.parametrize('max_rois', [None, 40, 64])
def test_mixup_blobs_is_bitwise_the_jax_packages(max_rois):
    rng = np.random.RandomState(1)
    blobs = []
    for h, w in ((48, 64), (56, 40)):
        entry = _entry(rng, h, w)
        crop = np.array([0, 0, h - 1, w - 1], np.int32)
        b = jax_minibatch.sample_rois(entry, 1.0, crop, 5, 24, pad_to=32)
        b['data'] = rng.randn(1, h, w, 3).astype(np.float32)
        b['im_hw'] = np.array([h, w], np.float32)
        blobs.append(b)
    got = minibatch.mixup_blobs(blobs[0], blobs[1], 0.3, max_rois=max_rois)
    want = jax_minibatch.mixup_blobs(blobs[0], blobs[1], 0.3,
                                     max_rois=max_rois)
    _same_blobs(got, want)
    stacked = ts.stack_minibatches([got], size_bucket=32)
    want_stacked = jax_ts.stack_minibatches([want], size_bucket=32)
    for k in ts.BATCH_KEYS:
        np.testing.assert_array_equal(stacked[k], want_stacked[k])
    assert stacked['image'].shape == (1, 1, 64, 64, 3)


def test_get_minibatch_follows_the_jax_packages_draws_and_blobs(tmp_path):
    """The same RandomState stream gives the same scale, crop and RoIs; the
    image differs by the resize (cv2 against torch, atol 2e-2) with the
    HSV jitter off; the jitter is held against cv2 on its own. One stated
    departure: ``im_hw`` is the image's own extent, where the JAX package
    records the bucket-padded canvas (its comment says the extent)."""
    import cv2
    entry = _entry(np.random.RandomState(2), 60, 80)
    path = str(tmp_path / 'im.png')
    cv2.imwrite(path, entry['image'])
    for c in (jax_config.cfg, port_config.cfg):
        c.TRAIN.SCALES = (48, 64)
        c.TRAIN.MAX_SIZE = 120
        c.TRAIN.BATCH_SIZE_PER_IM = 24
        c.MODEL.NUM_CLASSES = 5
        c.WSL.USE_DISTORTION = False
    want = jax_minibatch.get_minibatch(
        dict(entry, image=path), rng=np.random.RandomState(5),
        pad_rois_to=32, size_bucket=32)
    got = minibatch.get_minibatch(entry, rng=np.random.RandomState(5),
                                  pad_rois_to=32, size_bucket=32)
    assert set(got) == set(want)
    for k in ('rois', 'obn_scores', 'labels_oh', 'labels_int32',
              'valid_mask', 'data_ids'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got['im_scale'] == want['im_scale']
    assert got['data'].shape == want['data'].shape
    np.testing.assert_allclose(got['data'], want['data'], atol=2e-2)
    # the departure: the extent before the bucket padding, which the JAX
    # package records as its im_hw
    unpadded = minibatch.get_minibatch(entry, rng=np.random.RandomState(5),
                                       pad_rois_to=32)
    h, w = unpadded['data'].shape[1:3]
    assert got['im_hw'].dtype == want['im_hw'].dtype == np.float32
    np.testing.assert_array_equal(got['im_hw'], [h, w])
    np.testing.assert_array_equal(want['im_hw'], got['data'].shape[1:3])
    assert (h, w) != got['data'].shape[1:3]

    for c in (jax_config.cfg, port_config.cfg):
        c.WSL.USE_DISTORTION = True
        c.WSL.USE_CROP = False
    want = jax_minibatch.distort_image_hsv(
        entry['image'], 1.5, 1.5, np.random.RandomState(9))
    got = minibatch.distort_image_hsv(
        entry['image'], 1.5, 1.5, np.random.RandomState(9))
    assert got.dtype == np.uint8 and got.shape == want.shape
    # each colour conversion is within one unit of cv2's fixed-point
    # tables; one unit of hue (2 degrees) can move a saturated pixel by
    # several units, so the jitter is held on its mean and its 99% quantile
    hsv = cv2.cvtColor(entry['image'], cv2.COLOR_BGR2HSV)
    mine = np.rint(minibatch._bgr_to_hsv(entry['image']))
    dh = np.abs(hsv.astype(np.int32) - mine.astype(np.int32))
    dh[..., 0] = np.minimum(dh[..., 0], 180 - dh[..., 0])
    assert dh.max() <= 1
    back = np.abs(cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR).astype(np.int32)
                  - minibatch._hsv_to_bgr(hsv).astype(np.int32))
    assert back.max() <= 1
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.mean() < 0.5 and (diff <= 2).mean() > 0.99


def test_checkpoint_with_momentum_round_trips_bitwise(tmp_path):
    _, params, model, batch = _fixture('flagship')
    hp, mults, state = train_engine.create_solver(model)
    for _ in range(2):
        ts.train_step(model, state, _port_batch(batch), np.float32(1e-3),
                      None, hp=hp, mults=mults)
    path = str(tmp_path / 'step.pkl')
    checkpoint.save_weights_file(path, model, momentum=state['momentum'])

    _, _, fresh, _ = _fixture('flagship', seed=3)
    _, _, state2 = train_engine.create_solver(fresh)
    assert checkpoint.initialize_from_weights_file(
        fresh, path, momentum=state2['momentum']) == []
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    for n, v in state['momentum'].items():
        assert torch.equal(v, state2['momentum'][n]), n
    assert state2['momentum']['fc6_w'].any()
    # the JAX package reads the same file: weights and momentum
    template = {k: np.zeros_like(v) for k, v in params.items()}
    jax_params, jax_mom, unmatched = (
        jax_ckpt.initialize_params_from_weights_file(template, path))
    assert unmatched == []
    got_p = state_to_jax_names(named_blobs(model))
    got_m = state_to_jax_names(state['momentum'])
    for n in params:
        np.testing.assert_array_equal(got_p[n], jax_params[n], err_msg=n)
        np.testing.assert_array_equal(got_m[n], jax_mom[n], err_msg=n)
    # and one more step from the reloaded state repeats the original's
    a, _ = ts.train_step(model, state, _port_batch(batch), np.float32(1e-3),
                         None, hp=hp, mults=mults)
    b, _ = ts.train_step(fresh, state2, _port_batch(batch),
                         np.float32(1e-3), None, hp=hp, mults=mults)
    assert a.item() == b.item()
    assert torch.equal(model.head.fc8c.weight, fresh.head.fc8c.weight)


def _tiny_cfg(base, output_dir=None):
    port_config.merge_cfg_from_cfg(base)
    c = port_config.cfg
    c.MODEL.NUM_CLASSES = 5
    c.TPU.HEAD_HIDDEN_DIM = 16
    c.TPU.COMPUTE_DTYPE = 'float32'
    c.TPU.ROI_PAD_MULTIPLE = 16
    c.TPU.SIZE_BUCKET_MULTIPLE = 32
    c.TRAIN.SCALES = (48, 64)
    c.TRAIN.MAX_SIZE = 100
    c.TRAIN.BATCH_SIZE_PER_IM = 24
    c.TRAIN.WEIGHTS = ''
    c.DATA_LOADER.NUM_THREADS = 1
    c.SOLVER.BASE_LR = 1e-4
    c.SOLVER.STEPS = [0, 2]
    c.RNG_SEED = 3
    if output_dir is not None:
        c.OUTPUT_DIR = output_dir


def _roidb(n=3):
    rng = np.random.RandomState(4)
    return [_entry(rng, 60, 80, classes=(1 + i % 2,)) for i in range(n)]


def test_train_model_flagship_runs_and_checkpoints(tmp_path):
    _tiny_cfg(port_config.FLAGSHIP, str(tmp_path))
    checkpoints, records = train_engine.train_model(_roidb(), max_iters=4,
                                                    device='cpu')
    out = tmp_path / 'train' / 'flickr_voc' / 'generalized_wsl'
    assert checkpoints == {'final': str(out / 'model_final.pkl')}
    assert [r['iter'] for r in records] == [0, 1, 2, 3]
    assert all(np.isfinite(r['loss']) for r in records)
    assert {'loss_cls', 'loss_cls_noise', 'class_weight_mean'} <= set(
        records[0])
    # the learning rate steps at iteration 2 and momentum is corrected once
    assert records[1]['lr'] == pytest.approx(1e-4)
    assert records[2]['lr'] == pytest.approx(1e-5)
    blobs, saved_cfg = checkpoint.load_weights_pkl(checkpoints['final'])
    assert 'fc6_w_momentum' in blobs and '_[noisy]_fc7_b_momentum' in blobs
    assert blobs['fc6_w_momentum'].any()
    assert not blobs['conv1_1_w_momentum'].any()
    # same seed, same run: the loop on a model of the caller's gives the
    # same losses, and the pkl holds its weights and momentum
    model = test_engine.initialize_model_from_cfg(device='cpu')
    solver = train_engine.create_solver(model)
    again = train_engine.train_loop(model, solver, _roidb(), max_iters=4)
    assert [r['loss'] for r in again] == [r['loss'] for r in records]
    state = solver[2]
    assert state['it'] == 4
    np.testing.assert_array_equal(blobs['fc8d_w'],
                                  model.head.fc8d.weight.detach().numpy())
    np.testing.assert_array_equal(blobs['fc6_w_momentum'],
                                  state['momentum']['fc6_w'].numpy())
    # resuming from a checkpoint restores weights and momentum: as
    # model_iter3.pkl it resumes at iteration 4 of 4 and saves them again
    os.rename(checkpoints['final'], str(out / 'model_iter3.pkl'))
    resumed, more = train_engine.train_model(_roidb(), max_iters=4,
                                             device='cpu')
    assert more == []
    blobs2, _ = checkpoint.load_weights_pkl(resumed['final'])
    assert set(blobs2) == set(blobs)
    for k in blobs:
        np.testing.assert_array_equal(blobs2[k], blobs[k], err_msg=k)


def test_train_model_csc_gates_on_cur_iter(tmp_path):
    _tiny_cfg(port_config.CSC, str(tmp_path))
    port_config.cfg.WSL.CPG_TAU = 0.0
    port_config.cfg.WSL.CSC_MAX_ITER = 2
    _, records = train_engine.train_model(_roidb(), max_iters=3,
                                          device='cpu')
    assert all(np.isfinite(r['loss_cls_pos']) and
               np.isfinite(r['loss_cls_neg']) for r in records)
    assert records[2]['loss_cls_neg'] == pytest.approx(0.0, abs=1e-6)
    assert not any(r['mixup'] for r in records)


def test_build_minibatch_blends_a_same_class_partner():
    _tiny_cfg(port_config.FLAGSHIP)
    roidb = _roidb(4)
    rng = np.random.RandomState(0)
    class2idx = loader.class_to_images(roidb)
    seen = [loader.build_minibatch(roidb, i % 4, rng, class2idx)
            for i in range(40)]
    mixed = [b for b in seen if b.get('mixup')]
    assert 0 < len(mixed) < 20
    for b in mixed:
        assert b['rois'].shape == (32, 5) and b['valid_mask'].all()
        assert b['data'].shape[1] % 32 == 0 and b['data'].shape[2] % 32 == 0
        assert b['labels_oh'].sum() == pytest.approx(1.0)
    plain = [b for b in seen if not b.get('mixup')]
    assert all(b['valid_mask'].sum() == 24 for b in plain)
