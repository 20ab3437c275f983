"""Inference orchestration (port of the JAX package's
``engine/test_engine.py``): the test roidb with its proposals, the
per-image loop of ``test_net`` with its ``all_boxes`` result layout and
``detections.pkl``, and ``run_inference`` -> ``test_net_on_dataset`` ->
evaluation, in one process (``--range`` shards and multi-process inference
are not ported yet and raise).

``test_net`` takes the model and a roidb: a list of entries, each a dict
with ``'image'``, an (H, W, 3) uint8 BGR array or the path of an image
file, ``'boxes'`` (R, 4) proposals in image coordinates and
``'obn_scores'`` (R,) or (R, 1) objectness; optional ``'gt_classes'`` (rows
with a class > 0 are ground truth and are skipped, as in the JAX package)
and ``'id'``.
"""

import logging
import os
from collections import defaultdict

import numpy as np

from nafwebsod_torch.core.config import (cfg, dump_cfg_or_none,
                                         get_output_dir)
from nafwebsod_torch.data import task_evaluation
from nafwebsod_torch.data.json_dataset import JsonDataset
from nafwebsod_torch.data.minibatch import read_image
from nafwebsod_torch.engine.test import check_protocol, im_detect_all
from nafwebsod_torch.models import detector
from nafwebsod_torch.utils import checkpoint as ckpt
from nafwebsod_torch.utils.io import save_object
from nafwebsod_torch.utils.timer import Timer

logger = logging.getLogger(__name__)


def get_roidb_and_dataset(dataset_name, proposal_file, ind_range=None):
    """(test roidb with its proposals, dataset)."""
    if ind_range is not None:
        raise NotImplementedError(
            'image index ranges (--range, multi-process inference) are not '
            'ported yet')
    dataset = JsonDataset(dataset_name)
    if cfg.TEST.PRECOMPUTED_PROPOSALS:
        assert proposal_file, 'No proposals exist for "{}"'.format(
            dataset_name)
        roidb = dataset.get_roidb(
            gt=True, proposal_file=proposal_file,
            proposal_limit=cfg.TEST.PROPOSAL_LIMIT)
    else:
        roidb = dataset.get_roidb(gt=True)
    return roidb, dataset


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
    """Detect on every roidb entry. Returns (all_boxes, all_segms,
    all_keyps) as the JAX package does: all_boxes[class][image] an (n, 5)
    float32 array (class 0 and proposal-less images stay []);
    all_segms[class][image] the list of that image's COCO RLEs, one per
    detection in the same order, with MODEL.MASK_ON (None otherwise);
    all_keyps None (keypoints are not ported). With ``output_dir`` it also
    writes ``detections.pkl`` there in the reference layout."""
    check_protocol()
    num_images = len(roidb)
    all_boxes = empty_results(cfg.MODEL.NUM_CLASSES, num_images)
    all_segms = (empty_results(cfg.MODEL.NUM_CLASSES, num_images)
                 if model.spec.mask_on else None)
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
        cls_boxes_i, cls_segms_i, _ = im_detect_all(
            model, read_image(entry['image']), boxes, obn, timers)
        extend_results(i, all_boxes, cls_boxes_i)
        if all_segms is not None:
            extend_results(i, all_segms, cls_segms_i)
        if i % 10 == 0:
            logger.info('im_detect: %d/%d (det %.3fs)', i + 1, num_images,
                        timers['im_detect_bbox'].average_time)
    if output_dir is not None:
        det_file = os.path.join(output_dir, 'detections.pkl')
        save_object(dict(all_boxes=all_boxes, all_segms=all_segms,
                         all_keyps=None,
                         cfg=dump_cfg_or_none(),
                         image_ids=[e.get('id', i)
                                    for i, e in enumerate(roidb)]),
                    det_file)
        logger.info('Wrote detections to: %s', os.path.abspath(det_file))
    return all_boxes, all_segms, None


def test_net_on_dataset(model, dataset_name, proposal_file, output_dir,
                        multi_gpu=False, images=None):
    """Detect on one dataset and evaluate its boxes. ``images``:
    optionally {image id: (H, W, 3) uint8 BGR array}, pixels handed over in
    place of the entries' image files. With MODEL.MASK_ON the masks are
    left as RLEs in ``detections.pkl`` and not scored: segm evaluation is
    not ported yet (``task_evaluation.evaluate_masks`` raises). Returns
    {dataset name: results}."""
    if multi_gpu:
        raise NotImplementedError(
            'multi-process inference is not ported yet')
    roidb, dataset = get_roidb_and_dataset(dataset_name, proposal_file)
    if images is not None:
        for entry in roidb:
            if entry['id'] in images:
                entry['image'] = images[entry['id']]
    test_timer = Timer()
    test_timer.tic()
    all_boxes, all_segms, _ = test_net(model, roidb, output_dir)
    test_timer.toc()
    logger.info('Total inference time: %.3fs', test_timer.average_time)
    if all_segms is not None:
        logger.warning(
            'segm evaluation is not ported yet: the masks of %s are in '
            'detections.pkl as RLEs and only its boxes are evaluated',
            dataset_name)
    # the ids in test_net's enumeration order, as detections.pkl holds them
    return task_evaluation.evaluate_all(
        dataset, all_boxes, None, None, output_dir,
        image_ids=[e['id'] for e in roidb])


def run_inference(weights_file=None, ind_range=None, multi_gpu_testing=False,
                  check_expected_results=False, device=None, images=None,
                  model=None):
    """Top-level entry: every TEST.DATASETS entry with its
    TEST.PROPOSAL_FILES entry, into ``get_output_dir``. The cfg's model is
    built on ``device`` (the card unless ``device='cpu'``) and filled from
    ``weights_file`` (seeded random weights without one), unless a built
    ``model`` is given. ``images`` as in ``test_net_on_dataset``. Returns
    {dataset name: results}."""
    if ind_range is not None or multi_gpu_testing:
        raise NotImplementedError(
            'image index ranges and multi-process inference are not ported '
            'yet')
    if model is None:
        model = initialize_model_from_cfg(weights_file, device=device)
    results = {}
    for i, dataset_name in enumerate(cfg.TEST.DATASETS):
        proposal_file = (cfg.TEST.PROPOSAL_FILES[i]
                         if cfg.TEST.PROPOSAL_FILES else None)
        output_dir = get_output_dir((dataset_name,), training=False)
        results.update(test_net_on_dataset(
            model, dataset_name, proposal_file, output_dir, images=images))
    if check_expected_results:
        # {dataset: {metric: value}} of the scalar metrics
        flat = {ds: {k: v for k, v in r.items()
                     if isinstance(v, (int, float, np.floating))}
                for ds, r in results.items()}
        task_evaluation.check_expected_results(
            flat, atol=cfg.EXPECTED_RESULTS_ATOL,
            rtol=cfg.EXPECTED_RESULTS_RTOL)
    return results
