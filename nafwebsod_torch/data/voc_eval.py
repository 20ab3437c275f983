"""PASCAL VOC detection evaluation: AP (07/12 metrics) and CorLoc (the
port's own copy of the JAX package's ``data/voc_eval.py``; pure numpy).

Capability parity with ``detectron/datasets/voc_eval.py``:
  * ``voc_ap``          — 11-point VOC07 metric / area-under-PR (ref :56-85)
  * ``voc_eval``        — per-class AP with difficult-object handling,
                          greedy matching at IoU > ovthresh (ref :88-222)
  * ``voc_eval_corloc`` — CorLoc on positive images: only each image's
                          top-scoring detection counts; all-difficult images
                          skipped; returns (corloc, too_min_rate) (ref :225-354)

Both file-based entry points (VOCdevkit-format detection txt files, one per
class: "<image_id> <score> <x1> <y1> <x2> <y2>" in 1-based coords) and
in-memory equivalents are provided. Annotations come from VOC xml files or a
pre-parsed {image_id: [obj dicts]} mapping. The implementation is this
repo's own (vectorized interpolation, shared matching helper); the metric
definitions are the protocol anchor and match the reference exactly.
"""

import logging
import os
import xml.etree.ElementTree as ET

import numpy as np

from nafwebsod_torch.utils.io import load_object, save_object

logger = logging.getLogger(__name__)


def _node_int(parent, tag, default=0):
    node = parent.find(tag)
    return int(node.text) if node is not None else default


def parse_rec(filename):
    """Parse a PASCAL VOC xml annotation file into a list of object dicts."""
    def to_obj(node):
        box = node.find('bndbox')
        pose = node.find('pose')
        return {
            'name': node.find('name').text,
            'pose': pose.text if pose is not None else '',
            'truncated': _node_int(node, 'truncated'),
            'difficult': _node_int(node, 'difficult'),
            'bbox': [int(float(box.find(side).text))
                     for side in ('xmin', 'ymin', 'xmax', 'ymax')],
        }
    return [to_obj(node) for node in ET.parse(filename).findall('object')]


def voc_ap(rec, prec, use_07_metric=False):
    """AP from a PR curve; VOC07 11-point interpolation when requested."""
    rec = np.asarray(rec, dtype=np.float64)
    prec = np.asarray(prec, dtype=np.float64)
    if use_07_metric:
        if rec.size == 0:
            return 0.0
        # best precision achievable at recall >= each point = suffix max
        peak = np.maximum.accumulate(prec[::-1])[::-1]
        # rec is non-decreasing (cumulative tp / npos): binary-search the
        # first index reaching each of the 11 recall thresholds
        first = np.searchsorted(rec, np.linspace(0.0, 1.0, 11), side='left')
        reachable = first < rec.size
        samples = np.where(reachable, peak[np.minimum(first, rec.size - 1)], 0.0)
        return float(samples.sum() / 11.0)
    # area under the interpolated (monotone) PR curve
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    step = np.flatnonzero(np.diff(mrec))
    return float(np.dot(np.diff(mrec)[step], mpre[step + 1]))


def _load_annots(annopath, imagesetfile, cachedir):
    """Read the image list and (cached) annotations."""
    with open(imagesetfile) as f:
        imagenames = [line.strip() for line in f]
    os.makedirs(cachedir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(imagesetfile))[0]
    cachefile = os.path.join(cachedir, stem + '_annots.pkl')
    if os.path.isfile(cachefile):
        return imagenames, load_object(cachefile)
    recs = {name: parse_rec(annopath.format(name)) for name in imagenames}
    save_object(recs, cachefile)
    return imagenames, recs


def _class_gt(recs, imagenames, classname):
    """Per-image gt boxes/difficult flags for one class + positive counts."""
    class_recs = {}
    npos = npos_im = 0
    for name in imagenames:
        objs = [o for o in recs[name] if o['name'] == classname]
        easy = sum(not o['difficult'] for o in objs)
        class_recs[name] = {
            'bbox': np.array([o['bbox'] for o in objs]),
            'difficult': np.array([o['difficult'] for o in objs], dtype=bool),
            'det': [False] * len(objs),
        }
        npos += easy
        npos_im += bool(objs) and min(easy, 1)
    return class_recs, npos, npos_im


def _read_dets_file(detfile):
    rows = []
    if os.path.exists(detfile):
        with open(detfile) as f:
            rows = [line.split() for line in f if line.strip()]
    if not rows:
        return [], np.zeros(0), np.zeros((0, 4))
    image_ids = [r[0] for r in rows]
    values = np.array([[float(v) for v in r[1:]] for r in rows])
    return image_ids, values[:, 0], values[:, 1:5]


def _gt_overlaps(det_box, gt_boxes):
    """IoU of one det box against all gt boxes (+1 pixel-area convention).

    Also returns the raw intersections (the CorLoc too-small diagnostic
    re-normalizes them by the det area)."""
    lo = np.maximum(gt_boxes[:, :2], det_box[:2])
    hi = np.minimum(gt_boxes[:, 2:4], det_box[2:4])
    wh = np.maximum(hi - lo + 1.0, 0.0)
    inters = wh[:, 0] * wh[:, 1]
    area = lambda b: (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    return inters / (area(det_box) + area(gt_boxes) - inters), inters


def _by_score(image_ids, confidence, bb):
    order = np.argsort(-confidence)
    return [image_ids[i] for i in order], bb[order, :]


def eval_class_dets(image_ids, confidence, bb, class_recs, npos,
                    ovthresh=0.5, use_07_metric=False):
    """Core AP computation on in-memory detections."""
    image_ids, bb = _by_score(image_ids, confidence, bb)

    n = len(image_ids)
    tp = np.zeros(n)
    fp = np.zeros(n)
    for d, (im, det_box) in enumerate(zip(image_ids, bb)):
        gt = class_recs[im]
        boxes = gt['bbox'].astype(float)
        if boxes.size == 0:
            fp[d] = 1.0
            continue
        overlaps, _ = _gt_overlaps(det_box.astype(float), boxes)
        j = int(np.argmax(overlaps))
        if overlaps[j] <= ovthresh:
            fp[d] = 1.0
        elif not gt['difficult'][j]:
            # greedy: each gt matches at most once; difficult gts absorb
            # their detections silently (neither tp nor fp)
            if gt['det'][j]:
                fp[d] = 1.0
            else:
                tp[d] = 1.0
                gt['det'][j] = True

    tp, fp = np.cumsum(tp), np.cumsum(fp)
    recall = tp / float(npos) if npos > 0 else np.zeros_like(tp)
    precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return recall, precision, voc_ap(recall, precision, use_07_metric)


def voc_eval(detpath, annopath, imagesetfile, classname, cachedir,
             ovthresh=0.5, use_07_metric=False):
    """File-based AP evaluation (reference-compatible signature)."""
    imagenames, recs = _load_annots(annopath, imagesetfile, cachedir)
    class_recs, npos, _ = _class_gt(recs, imagenames, classname)
    image_ids, confidence, bb = _read_dets_file(detpath.format(classname))
    if not image_ids:
        return np.zeros(0), np.zeros(0), 0.0
    return eval_class_dets(image_ids, confidence, bb, class_recs, npos,
                           ovthresh, use_07_metric)


def eval_class_corloc(image_ids, confidence, bb, class_recs, npos_im,
                      ovthresh=0.5):
    """Core CorLoc computation on in-memory detections (ref :297-354)."""
    image_ids, bb = _by_score(image_ids, confidence, bb)

    hit_ims, miss_ims = set(), set()
    too_min = 0
    for im, det_box in zip(image_ids, bb):
        if im in hit_ims or im in miss_ims:
            continue  # only each image's TOP-scoring detection counts
        gt = class_recs[im]
        # images with no (non-difficult) gt of this class are skipped
        # entirely (ref :306-311: all_difficult stays True for empty lists)
        if gt['difficult'].size == 0 or gt['difficult'].all():
            continue
        det_box = det_box.astype(float)
        overlaps, inters = _gt_overlaps(det_box, gt['bbox'].astype(float))
        if np.max(overlaps) > ovthresh:
            hit_ims.add(im)
            continue
        miss_ims.add(im)
        # diagnostic: would the det match under intersection/det-area?
        det_area = ((det_box[2] - det_box[0] + 1.0) *
                    (det_box[3] - det_box[1] + 1.0))
        too_min += np.max(inters / det_area) > ovthresh

    too_min_rate = too_min / len(miss_ims) if miss_ims else 0.0
    corloc = len(hit_ims) / npos_im if npos_im > 0 else 0.0
    return corloc, too_min_rate


def voc_eval_corloc(detpath, annopath, imagesetfile, classname, cachedir,
                    ovthresh=0.5, use_07_metric=False):
    """File-based CorLoc evaluation (reference-compatible signature)."""
    imagenames, recs = _load_annots(annopath, imagesetfile, cachedir)
    class_recs, _, npos_im = _class_gt(recs, imagenames, classname)
    image_ids, confidence, bb = _read_dets_file(detpath.format(classname))
    if not image_ids:
        return 0.0, 0.0
    return eval_class_corloc(image_ids, confidence, bb, class_recs, npos_im,
                             ovthresh)
