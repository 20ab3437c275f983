"""VOC-style evaluation over detection results (the port's own copy of
the JAX package's ``data/voc_dataset_evaluator.py``; pure numpy).

Capability parity with ``detectron/datasets/voc_dataset_evaluator.py``:
writes VOCdevkit-format per-class result files (1-based coords, salted
comp4 filenames), runs the python AP eval (VOC07 metric for year < 2010)
and the CorLoc eval, and saves per-class PR / corloc pkls into the output
dir. The devkit file layout and line format are byte-compatible (external
MATLAB/devkit tooling consumes them); the orchestration around them is this
repo's own (one foreground-class iterator shared by writer and evals).
"""

import logging
import os
import shutil
import uuid

import numpy as np

from nafwebsod_torch.data import catalog
from nafwebsod_torch.data.voc_eval import voc_eval, voc_eval_corloc
from nafwebsod_torch.utils.io import save_object

logger = logging.getLogger(__name__)

# VOCdevkit line format: 1-based coords, one det per line
_DET_LINE = '{:s} {:.9f} {:.1f} {:.1f} {:.1f} {:.1f}\n'


def voc_info(json_dataset):
    name = json_dataset.name
    # voc_<year>_<set> or webly sets evaluated against a VOC devkit
    parts = name.split('_')
    year, image_set = (
        (parts[1], '_'.join(parts[2:])) if parts[0] == 'voc'
        else ('2007', 'test'))
    devkit_path = catalog.get_devkit_dir(name)
    assert devkit_path and os.path.exists(devkit_path), \
        'Devkit directory {} not found'.format(devkit_path)
    voc_root = os.path.join(devkit_path, 'VOC' + year)
    return {
        'year': year,
        'image_set': image_set,
        'devkit_path': devkit_path,
        'anno_path': os.path.join(voc_root, 'Annotations', '{:s}.xml'),
        'image_set_path': os.path.join(voc_root, 'ImageSets', 'Main',
                                       image_set + '.txt'),
    }


def _result_files(json_dataset, salt):
    """Yield (class_index, class_name, devkit result-file path) for every
    foreground class. The comp4 filename scheme is the devkit contract."""
    info = voc_info(json_dataset)
    dirname = os.path.join(info['devkit_path'], 'results',
                           'VOC' + info['year'], 'Main')
    os.makedirs(dirname, exist_ok=True)
    stem = 'comp4{}_det_{}_'.format(salt, info['image_set'])
    for ind, cls in enumerate(json_dataset.classes):
        if cls != '__background__':
            yield ind, cls, os.path.join(dirname, stem + cls + '.txt')


def _image_index(json_dataset):
    with open(voc_info(json_dataset)['image_set_path']) as f:
        return [line.strip() for line in f]


def _det_lines(index, dets):
    """Format one image's (n, 5) [x1 y1 x2 y2 score] rows as devkit lines."""
    if isinstance(dets, list):  # empty placeholder from empty_results
        assert len(dets) == 0
        return []
    return [_DET_LINE.format(index, row[-1], row[0] + 1, row[1] + 1,
                             row[2] + 1, row[3] + 1) for row in dets]


def _write_voc_results_files(json_dataset, all_boxes, salt):
    image_index = _image_index(json_dataset)
    filenames = []
    for cls_ind, _, path in _result_files(json_dataset, salt):
        per_image = all_boxes[cls_ind]
        assert len(per_image) == len(image_index)
        with open(path, 'wt') as f:
            f.writelines(
                line for index, dets in zip(image_index, per_image)
                for line in _det_lines(index, dets))
        filenames.append(path)
    return filenames


def _do_python_eval(json_dataset, salt, output_dir):
    info = voc_info(json_dataset)
    cachedir = os.path.join(info['devkit_path'], 'annotations_cache')
    use_07_metric = int(info['year']) < 2010
    os.makedirs(output_dir, exist_ok=True)
    aps = {}
    for _, cls, path in _result_files(json_dataset, salt):
        rec, prec, ap = voc_eval(path, info['anno_path'],
                                 info['image_set_path'], cls, cachedir,
                                 ovthresh=0.5, use_07_metric=use_07_metric)
        aps[cls] = ap
        logger.info('AP for %s = %.4f', cls, ap)
        save_object({'rec': rec, 'prec': prec, 'ap': ap},
                    os.path.join(output_dir, cls + '_pr.pkl'))
    mAP = np.mean(list(aps.values())) if aps else 0.0
    logger.info('Mean AP = %.4f', mAP)
    return aps, mAP


def _do_python_eval_corloc(json_dataset, salt, output_dir):
    info = voc_info(json_dataset)
    cachedir = os.path.join(info['devkit_path'], 'annotations_cache')
    os.makedirs(output_dir, exist_ok=True)
    corlocs = {}
    for _, cls, path in _result_files(json_dataset, salt):
        corloc, too_min_rate = voc_eval_corloc(
            path, info['anno_path'], info['image_set_path'], cls,
            cachedir, ovthresh=0.5)
        corlocs[cls] = corloc
        logger.info('CorLoc for %s = %.4f', cls, corloc)
        save_object({'corloc': corloc},
                    os.path.join(output_dir, cls + '_corloc.pkl'))
    mean_corloc = np.mean(list(corlocs.values())) if corlocs else 0.0
    logger.info('Mean CorLoc = %.4f', mean_corloc)
    return corlocs, mean_corloc


def _check_alignment(json_dataset, image_ids):
    """The devkit evaluator reads ``all_boxes[cls][i]`` as the i-th line of
    the image-set file. ``image_ids`` are the detection-time ids in that
    positional order: their file stems must be that list, or every
    detection would be scored against another image's annotations."""
    stems = [os.path.splitext(json_dataset.COCO.imgs[i]['file_name'])[0]
             for i in image_ids]
    image_index = _image_index(json_dataset)
    if stems != image_index:
        raise ValueError(
            'detections of {} ({} images, first {}) do not line up with the '
            'image set {} ({} images, first {})'.format(
                json_dataset.name, len(stems), stems[:3],
                voc_info(json_dataset)['image_set_path'], len(image_index),
                image_index[:3]))


def evaluate_boxes(json_dataset, all_boxes, output_dir, use_salt=True,
                   cleanup=True, image_ids=None):
    """Returns {'ap': per-class, 'mAP': float, 'corloc': per-class,
    'mean_corloc': float}. With ``image_ids`` (the ids of the detected
    images, in ``all_boxes``' order) the alignment with the devkit's image
    set is checked first."""
    if image_ids is not None:
        _check_alignment(json_dataset, image_ids)
    salt = '_{}'.format(uuid.uuid4()) if use_salt else ''
    filenames = _write_voc_results_files(json_dataset, all_boxes, salt)
    aps, mAP = _do_python_eval(json_dataset, salt, output_dir)
    corlocs, mean_corloc = _do_python_eval_corloc(json_dataset, salt,
                                                  output_dir)
    if cleanup:
        for filename in filenames:
            shutil.copy(filename, output_dir)
            os.remove(filename)
    return {'ap': aps, 'mAP': mAP, 'corloc': corlocs,
            'mean_corloc': mean_corloc}
