"""Inference orchestration (port of the JAX package's
``engine/test_engine.py``: the per-image loop of ``test_net`` and its
``all_boxes`` result layout).

The roidb is given as a list of entries, each a dict with ``'image'``, an
(H, W, 3) uint8 BGR array, ``'boxes'`` (R, 4) proposals in image
coordinates and ``'obn_scores'`` (R,) or (R, 1) objectness; optional
``'gt_classes'`` (rows with a class > 0 are ground truth and are skipped,
as in the JAX package) and ``'id'``. Dataset loading, the evaluators and a
CLI are not ported yet.
"""

import logging
import os
from collections import defaultdict

import numpy as np

from nafwebsod_torch.core.config import cfg, dump_cfg
from nafwebsod_torch.engine.test import check_protocol, im_detect_all
from nafwebsod_torch.models import detector
from nafwebsod_torch.utils import checkpoint as ckpt
from nafwebsod_torch.utils.io import save_object
from nafwebsod_torch.utils.timer import Timer

logger = logging.getLogger(__name__)


def empty_results(num_classes, num_images):
    """all_boxes[class][image] = [] (the reference's detection layout)."""
    return [[[] for _ in range(num_images)] for _ in range(num_classes)]


def extend_results(index, all_res, im_res):
    for cls_idx in range(1, len(im_res)):
        all_res[cls_idx][index] = im_res[cls_idx]


def initialize_model_from_cfg(weights_file=None, device=None):
    """The cfg's model on ``device`` (the card unless ``device='cpu'``):
    seeded with cfg.RNG_SEED, then filled from a reference-format pkl when
    ``weights_file`` is given."""
    spec = detector.spec_from_cfg(cfg)
    model = detector.build_model(spec, device=device, seed=cfg.RNG_SEED)
    if weights_file:
        ckpt.initialize_from_weights_file(model, weights_file,
                                          strict_shapes=False)
    return model


def test_net(model, roidb, output_dir=None, timers=None):
    """Detect on every roidb entry. Returns all_boxes[class][image], each
    an (n, 5) float32 array (class 0 and proposal-less images stay []).
    With ``output_dir`` it also writes ``detections.pkl`` there in the
    reference layout."""
    check_protocol()
    num_images = len(roidb)
    all_boxes = empty_results(cfg.MODEL.NUM_CLASSES, num_images)
    if timers is None:
        timers = defaultdict(Timer)
    for i, entry in enumerate(roidb):
        boxes = np.asarray(entry['boxes'])
        obn = np.asarray(entry['obn_scores'])
        if 'gt_classes' in entry:
            proposal = np.asarray(entry['gt_classes']) == 0
            boxes, obn = boxes[proposal], obn[proposal]
        if len(boxes) == 0:
            continue
        cls_boxes_i, _, _ = im_detect_all(model, entry['image'], boxes, obn,
                                          timers)
        extend_results(i, all_boxes, cls_boxes_i)
        if i % 10 == 0:
            logger.info('im_detect: %d/%d (det %.3fs)', i + 1, num_images,
                        timers['im_detect_bbox'].average_time)
    if output_dir is not None:
        det_file = os.path.join(output_dir, 'detections.pkl')
        save_object(dict(all_boxes=all_boxes, all_segms=None, all_keyps=None,
                         cfg=dump_cfg(),
                         image_ids=[e.get('id', i)
                                    for i, e in enumerate(roidb)]),
                    det_file)
        logger.info('Wrote detections to: %s', os.path.abspath(det_file))
    return all_boxes
