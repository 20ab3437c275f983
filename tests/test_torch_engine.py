"""The port's inference path (nafwebsod_torch/engine, ops/jbox.py,
data/minibatch.py) against the JAX package on the CPU, on bridged
weights.

Tolerances: the image blob at atol 2e-2 pixel units (bilinear resize
against cv2's float path); NMS indices and keep masks identical on
tie-free scores; per-class detection sets at rtol/atol 1e-5 after a row
sort (tests/test_engine.py::TestFusedDetect).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafwebsod_tpu.core import config as jax_config
from nafwebsod_tpu.data.minibatch import pad_image_to_bucket as jax_pad
from nafwebsod_tpu.data.minibatch import prep_im_for_blob as jax_prep
from nafwebsod_tpu.engine import test as jax_infer
from nafwebsod_tpu.models import detector as jax_detector
from nafwebsod_tpu.ops import jbox as jax_jbox
from nafwebsod_torch.core import config as port_config
from nafwebsod_torch.data import minibatch
from nafwebsod_torch.engine import test as infer
from nafwebsod_torch.engine import test_engine
from nafwebsod_torch.models import detector
from nafwebsod_torch.ops import jbox
from nafwebsod_torch.utils.bridge import params_from_jax
from nafwebsod_torch.utils.io import load_object


@pytest.fixture(autouse=True)
def _fresh_cfgs():
    jax_config.reset_cfg()
    port_config.reset_cfg()
    yield
    jax_config.reset_cfg()
    port_config.reset_cfg()


def _set_both(key, value):
    for c in (jax_config.cfg, port_config.cfg):
        node = c
        *path, last = key.split('.')
        for p in path:
            node = node[p]
        node[last] = value


def _fixture(logit_gain):
    """tests/test_engine.py::TestFusedDetect._setup: fc8 weights scaled to
    spread the softmaxes, small-signal pixels around the mean, two
    injected duplicate proposals."""
    for key, value in [('MODEL.NUM_CLASSES', 5), ('TEST.SCALE', 64),
                       ('TEST.MAX_SIZE', 120), ('TEST.SCORE_THRESH', 1e-9),
                       ('TEST.NMS', 0.5), ('TEST.DETECTIONS_PER_IM', 10),
                       ('TPU.ROI_PAD_MULTIPLE', 16),
                       ('TPU.SIZE_BUCKET_MULTIPLE', 32)]:
        _set_both(key, value)
    spec = jax_detector.ModelSpec(num_classes=5, hidden_dim=16,
                                  compute_dtype='float32')
    params = dict(jax_detector.init_params(spec, jax.random.PRNGKey(0)))
    for k in ('fc8c_w', 'fc8d_w', 'noisy_fc8c_w', 'noisy_fc8d_w'):
        params[k] = params[k] * logit_gain
    rng = np.random.RandomState(0)
    im = np.clip(jax_config.cfg.PIXEL_MEANS.reshape(1, 1, 3) +
                 rng.randn(60, 80, 3) * 8, 0, 255).astype(np.uint8)
    boxes = rng.uniform(0, 50, (24, 4)).astype(np.float32)
    boxes[:, 2:] = np.minimum(boxes[:, :2] + 6 +
                              rng.uniform(0, 25, (24, 2)), 79)
    boxes[:, 3] = np.minimum(boxes[:, 3], 59)
    boxes[5] = boxes[0]
    boxes[6] = boxes[1]
    obn = rng.rand(24, 1).astype(np.float32)
    obn[5] = obn[0]
    obn[6] = obn[1]
    model = detector.build_model(
        detector.ModelSpec(num_classes=5, hidden_dim=16), device='cpu')
    model.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in params.items()}))
    return spec, params, model, im, boxes, obn


def _sorted(d):
    d = np.asarray(d, np.float32).reshape(-1, 5)
    return d[np.lexsort(d.T)]


def _assert_same_detections(got, want):
    assert len(got) == len(want) == port_config.cfg.MODEL.NUM_CLASSES
    for j in range(1, len(want)):
        g, w = _sorted(got[j]), _sorted(want[j])
        assert g.shape == w.shape, j
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                   err_msg='class %d' % j)


@pytest.mark.parametrize('logit_gain', [30.0, 3.0])
def test_im_detect_all_matches_jax_fused(logit_gain):
    spec, params, model, im, boxes, obn = _fixture(logit_gain)
    want = jax_infer.im_detect_fused(spec, params, im, boxes, obn)
    got, segms, keyps = infer.im_detect_all(model, im, boxes, obn)
    assert segms is None and keyps is None
    _assert_same_detections(got, want)
    assert sum(len(d) for d in got[1:]) > 0


def test_two_call_route_matches_jax():
    spec, params, model, im, boxes, obn = _fixture(3.0)
    want_s, want_b, want_scale = jax_infer.im_detect_bbox(
        spec, params, im, 64, 120, boxes=boxes, obn_scores=obn)
    s, b, scale = infer.im_detect_bbox(model, im, 64, 120, boxes, obn)
    assert scale == want_scale
    np.testing.assert_array_equal(b, want_b)
    np.testing.assert_allclose(s, want_s, rtol=1e-5, atol=1e-6)
    # the same scores through both packages' NMS-and-limit
    _, _, want = jax_infer.box_results_with_nms_and_limit(want_s, want_b)
    _, _, got = infer.box_results_with_nms_and_limit(want_s, want_b, 'cpu')
    _assert_same_detections(got, want)


@pytest.mark.parametrize('max_keep,limit', [(100, 100), (100, 0), (20, 50)])
def test_multiclass_nms_limit_matches_jax(max_keep, limit):
    rng = np.random.RandomState(max_keep + limit)
    c, r = 6, 300
    xy = rng.uniform(0, 400, (r, 2))
    b = np.concatenate([xy, xy + rng.uniform(5, 200, (r, 2))],
                       1).astype(np.float32)
    boxes = np.broadcast_to(b, (c, r, 4)).copy()
    scores = rng.rand(c, r).astype(np.float32)   # tie-free
    scores[:, 250:] = -np.inf                    # padded rows
    want = jax_jbox.multiclass_nms_limit(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.float32(0.5),
        jnp.float32(0.3), max_keep=max_keep, limit=limit)
    got = jbox.multiclass_nms_limit(torch.from_numpy(boxes),
                                    torch.from_numpy(scores), 0.5, 0.3,
                                    max_keep, limit)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(
        jbox.iou_matrix(torch.from_numpy(b), torch.from_numpy(b[:50])),
        np.asarray(jax_jbox.iou_matrix(jnp.asarray(b), jnp.asarray(b[:50]))),
        rtol=1e-6)


@pytest.mark.parametrize('h,w,target,max_size', [
    (375, 500, 688, 4000), (500, 333, 688, 4000), (60, 80, 64, 120),
    (480, 640, 400, 1000), (100, 300, 50, 120)])
def test_image_blob_matches_cv2_path(h, w, target, max_size):
    rng = np.random.RandomState(h + w)
    im = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    means = port_config.cfg.PIXEL_MEANS
    stds = np.array([[[1.0, 2.0, 1.0]]])
    want, want_scale = jax_prep(im.copy(), means, target, max_size, stds)
    got, scale = minibatch.prep_im_for_blob(im, means, target, max_size,
                                            stds)
    assert scale == want_scale
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2)
    np.testing.assert_array_equal(
        minibatch.pad_image_to_bucket(got, 64).numpy(),
        jax_pad(got.numpy(), 64))


def test_size_only_interpolate_is_the_resize_trap():
    """F.interpolate(size=...) maps pixels with in/out, not cv2's 1/s."""
    rng = np.random.RandomState(1)
    im = rng.randint(0, 256, (375, 500, 3)).astype(np.uint8)
    want, _ = jax_prep(im.copy(), np.zeros((1, 1, 3)), 688, 4000)
    x = torch.from_numpy(im).float().permute(2, 0, 1)[None]
    naive = torch.nn.functional.interpolate(
        x, size=want.shape[:2], mode='bilinear', align_corners=False)
    assert np.abs(naive[0].permute(1, 2, 0).numpy() - want).max() > 1.0


def test_dedup_matches_jax():
    _set_both('DEDUP_BOXES', 0.125)
    rng = np.random.RandomState(2)
    boxes = rng.uniform(0, 200, (50, 4)).astype(np.float32)
    boxes[10:20] = boxes[:10] + 0.01        # alias at 1/8 resolution
    obn = rng.rand(50).astype(np.float32)
    want = jax_infer._dedup_scaled_rois(boxes, obn, 1.7)
    got = infer._dedup_scaled_rois(boxes, obn, 1.7)
    assert got[0].shape[0] < 50
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_test_net_over_a_roidb(tmp_path):
    spec, params, model, im, boxes, obn = _fixture(3.0)
    want = jax_infer.im_detect_fused(spec, params, im, boxes, obn)
    gt = np.zeros(26, np.int32)
    gt[:2] = 3                              # ground-truth rows are skipped
    roidb = [
        {'image': im, 'id': 7,
         'boxes': np.vstack([np.full((2, 4), 5.0, np.float32), boxes]),
         'obn_scores': np.vstack([np.ones((2, 1), np.float32), obn]),
         'gt_classes': gt},
        {'image': im, 'id': 8, 'boxes': np.zeros((0, 4), np.float32),
         'obn_scores': np.zeros((0, 1), np.float32)},
    ]
    pytest.importorskip('yaml')  # detections.pkl records the cfg as YAML
    all_boxes = test_engine.test_net(model, roidb, output_dir=str(tmp_path))
    _assert_same_detections([all_boxes[j][0] for j in range(5)], want)
    assert all(all_boxes[j][1] == [] for j in range(5))
    saved = load_object(str(tmp_path / 'detections.pkl'))
    assert saved['image_ids'] == [7, 8]
    assert saved['all_segms'] is None
    for j in range(1, 5):
        np.testing.assert_array_equal(saved['all_boxes'][j][0],
                                      all_boxes[j][0])


def test_unported_protocols_raise():
    spec, params, model, im, boxes, obn = _fixture(3.0)
    port_config.cfg.TEST.SOFT_NMS.ENABLED = True
    with pytest.raises(NotImplementedError):
        infer.im_detect_all(model, im, boxes, obn)


def test_entry_points_without_device_raise_on_a_gpu_less_box():
    if torch.cuda.is_available():
        pytest.skip('this box has a GPU')
    port_config.merge_cfg_from_cfg(port_config.FLAGSHIP)
    port_config.cfg.TPU.HEAD_HIDDEN_DIM = 8
    with pytest.raises(RuntimeError):
        test_engine.initialize_model_from_cfg()
    model = test_engine.initialize_model_from_cfg(device='cpu')
    assert model.device.type == 'cpu'
