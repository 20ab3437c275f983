"""Evaluation dispatch and the EXPECTED_RESULTS regression gate (the port's
own copy of the JAX package's ``data/task_evaluation.py``): box results go
to the VOC evaluator (AP and CorLoc, for datasets with a devkit). The COCO
and Cityscapes evaluators, masks and keypoints are not ported yet and
raise ``NotImplementedError``."""

import logging
import os

from nafwebsod_torch.core.config import cfg
from nafwebsod_torch.data import catalog, voc_dataset_evaluator

logger = logging.getLogger(__name__)


def _use_voc_evaluator(dataset_name):
    if cfg.TEST.FORCE_JSON_DATASET_EVAL:
        return False
    try:
        devkit = catalog.get_devkit_dir(dataset_name)
    except KeyError:
        return False
    return bool(devkit) and os.path.exists(devkit)


def evaluate_boxes(json_dataset, all_boxes, output_dir, image_ids=None):
    logger.info('Evaluating detections')
    if not _use_voc_evaluator(json_dataset.name):
        raise NotImplementedError(
            'dataset {} has no VOC devkit directory (or '
            'TEST.FORCE_JSON_DATASET_EVAL is set): the COCO-protocol and '
            'Cityscapes evaluators are not ported yet'.format(
                json_dataset.name))
    return voc_dataset_evaluator.evaluate_boxes(
        json_dataset, all_boxes, output_dir, image_ids=image_ids)


def evaluate_all(dataset, all_boxes, all_segms, all_keyps, output_dir,
                 image_ids=None):
    """{dataset name: {'ap', 'mAP', 'corloc', 'mean_corloc'}}.
    ``image_ids``: the detection-time ids of the images, aligned with the
    positional index of all_boxes[cls][i] (``test_net`` saves them in
    detections.pkl); the evaluator checks them against the devkit's image
    set."""
    if all_segms is not None or all_keyps is not None:
        raise NotImplementedError(
            'mask and keypoint evaluation are not ported yet')
    res = evaluate_boxes(dataset, all_boxes, output_dir,
                         image_ids=image_ids)
    return {dataset.name: res}


def check_expected_results(results, atol=0.005, rtol=0.1):
    """Compare against cfg.EXPECTED_RESULTS [(dataset, task, metric,
    value)]; returns whether every listed metric is within tolerance."""
    expected = cfg.EXPECTED_RESULTS
    if not expected:
        return True
    ok = True
    for dataset, task, metric, expected_val in expected:
        if dataset not in results:
            logger.warning('EXPECTED_RESULTS: dataset %s not evaluated',
                           dataset)
            ok = False
            continue
        actual = results[dataset].get(metric)
        if actual is None:
            logger.warning('EXPECTED_RESULTS: metric %s missing', metric)
            ok = False
            continue
        err = abs(actual - expected_val)
        tol = atol + rtol * abs(expected_val)
        if err > tol:
            logger.error(
                'FAIL: %s/%s/%s actual %.4f != expected %.4f (tol %.4f)',
                dataset, task, metric, actual, expected_val, tol)
            ok = False
        else:
            logger.info(
                'PASS: %s/%s/%s actual %.4f ~= expected %.4f',
                dataset, task, metric, actual, expected_val)
    return ok
