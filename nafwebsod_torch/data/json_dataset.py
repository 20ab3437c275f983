"""COCO-json dataset -> roidb: the box-and-proposal path (the port's own
copy of that part of the JAX package's ``data/json_dataset.py``; pure
numpy).

  * roidb entries with boxes / obn_scores / gt_classes / seg_areas /
    gt_overlaps / is_crowd / box_to_gt_ind_map / max_classes /
    max_overlaps: the same schema, dtypes and row order as the JAX
    package's entries
  * gt annotation loading with clipping, GT_MIN_AREA and 'ignore'
    filtering, and the webly zeroing (an image whose every object is
    difficult AND truncated keeps no gt at all)
  * proposal pkl ingestion: sort by id, dedup via quantized hashing,
    min-size filter, score-descending sort, top-k limit
  * crowd filtering, class assignments and the train-time no-class filter

Masks, keypoints and pseudo ground truth are not ported: MODEL.MASK_ON,
MODEL.KEYPOINTS_ON and USE_PSEUDO raise ``NotImplementedError``, and the
entries carry no ``segms`` / ``gt_keypoints``.

gt_overlaps is a dense (N, num_classes) float array.
"""

import copy
import logging
import os

import numpy as np

from nafwebsod_torch.core.config import cfg
from nafwebsod_torch.data import catalog
from nafwebsod_torch.data.coco_json import COCOJson
from nafwebsod_torch.ops import boxes as box_utils
from nafwebsod_torch.utils.io import load_object

logger = logging.getLogger(__name__)


def _block(num_classes, boxes, classes=None, obn_scores=None, areas=None,
           crowds=None, gt_inds=None, overlaps=None):
    """One block of roidb rows as {column: array}, in the entry schema of
    the JAX package (boxes float32 (n, 4), obn_scores float32 (n, 1),
    gt_classes int32, seg_areas float32, gt_overlaps float32
    (n, num_classes), is_crowd bool, box_to_gt_ind_map int32); a column
    left out takes its default (class 0, score 0, area 0, not crowd, gt
    index -1, all-zero overlaps)."""
    n = len(boxes)

    def fill(x, default, dtype):
        if x is None:
            return np.full((n,), default, dtype)
        return np.asarray(x).astype(dtype)

    if overlaps is None:
        overlaps = np.zeros((n, num_classes), np.float32)
    return {
        'boxes': np.asarray(boxes, np.float32).reshape(n, 4),
        'obn_scores': fill(obn_scores, 0.0, np.float32).reshape(n, 1),
        'gt_classes': fill(classes, 0, np.int32),
        'seg_areas': fill(areas, 0.0, np.float32),
        'gt_overlaps': np.asarray(overlaps, np.float32).reshape(
            n, num_classes),
        'is_crowd': fill(crowds, False, bool),
        'box_to_gt_ind_map': fill(gt_inds, -1, np.int32),
    }


def _append_rows(entry, block):
    for col, arr in block.items():
        entry[col] = (np.concatenate([entry[col], arr], axis=0)
                      if col in entry else arr)


class JsonDataset:
    def __init__(self, name):
        self.name = name
        self.image_directory = catalog.get_im_dir(name)
        self.image_prefix = catalog.get_im_prefix(name)
        self.COCO = COCOJson(catalog.get_ann_fn(name))
        cat_ids = self.COCO.getCatIds()
        names = [c['name'] for c in self.COCO.loadCats(cat_ids)]
        self.category_to_id_map = dict(zip(names, cat_ids))
        self.classes = ['__background__'] + names
        self.num_classes = len(self.classes)
        self.json_category_id_to_contiguous_id = {
            cid: i + 1 for i, cid in enumerate(cat_ids)}
        self.contiguous_category_id_to_json_id = {
            i + 1: cid for i, cid in enumerate(cat_ids)}

    def get_roidb(self, gt=False, proposal_file=None, min_proposal_size=20,
                  proposal_limit=-1, crowd_filter_thresh=0):
        unported = [k for k, on in (
            ('MODEL.MASK_ON', cfg.MODEL.MASK_ON),
            ('MODEL.KEYPOINTS_ON', cfg.MODEL.KEYPOINTS_ON),
            ('USE_PSEUDO', cfg.USE_PSEUDO)) if on]
        if unported:
            raise NotImplementedError(
                'the roidb of {} is not ported yet'.format(
                    ', '.join(unported)))
        if crowd_filter_thresh > 0 and not gt:
            raise AssertionError(
                'Crowd filter threshold must be 0 if gt annotations are '
                'not included')
        roidb = self._blank_roidb()
        if gt:
            for entry in roidb:
                _append_rows(entry, self._gt_rows(entry))
        if proposal_file is not None:
            self._merge_proposals(roidb, proposal_file, min_proposal_size,
                                  proposal_limit)
            if crowd_filter_thresh > 0:
                for entry in roidb:
                    _suppress_crowd_proposals(entry, crowd_filter_thresh)
        for entry in roidb:
            _assign_classes(entry)
        if gt and 'test' not in self.name:
            kept = [e for e in roidb if e['max_classes'].sum() != 0]
            logger.info('roidb filtered from %d to %d entries', len(roidb),
                        len(kept))
            return kept
        return roidb

    def _blank_roidb(self):
        """Fresh entries for every image, sorted by image id: the image
        path and empty schema columns, COCO bookkeeping keys dropped."""
        image_ids = sorted(self.COCO.getImgIds())
        roidb = copy.deepcopy(self.COCO.loadImgs(image_ids))
        for entry in roidb:
            entry['dataset_name'] = self.name
            entry['image'] = os.path.join(
                self.image_directory,
                self.image_prefix + entry['file_name'])
            entry['flipped'] = False
            entry.update(_block(self.num_classes, np.zeros((0, 4))))
            for k in ('date_captured', 'url', 'license', 'file_name'):
                entry.pop(k, None)
        return roidb

    @staticmethod
    def _clean_box(obj, width, height):
        """Valid clipped xyxy box for one annotation, or None when the box
        is degenerate after clipping."""
        x1, y1, x2, y2 = box_utils.clip_xyxy_to_image(
            *box_utils.xywh_to_xyxy(obj['bbox']), height, width)
        if obj.get('area', 0) <= 0 or x2 <= x1 or y2 <= y1:
            return None
        return [x1, y1, x2, y2]

    def _gt_rows(self, entry):
        """Ground-truth rows for one image."""
        objs = self.COCO.loadAnns(self.COCO.getAnnIds(imgIds=entry['id']))
        width, height = entry['width'], entry['height']
        kept = []
        # webly zeroing: an image whose every (area / ignore surviving)
        # object is marked difficult AND truncated keeps no gt at all (json
        # key 'diffcult', as in the data). The flags are read BEFORE the
        # box is validated: an easy object with a degenerate box still
        # rescues the image.
        easy_seen = False
        for obj in objs:
            if obj.get('area', 0) < cfg.TRAIN.GT_MIN_AREA:
                continue
            if obj.get('ignore', 0) == 1:
                continue
            if obj.get('diffcult', 0) == 0 or obj.get('truncated', 0) == 0:
                easy_seen = True
            box = self._clean_box(obj, width, height)
            if box is not None:
                kept.append((obj, box))
        if not easy_seen:
            kept = []
        n = len(kept)
        classes = np.array(
            [self.json_category_id_to_contiguous_id[o['category_id']]
             for o, _ in kept], np.int32)
        crowds = np.array([bool(o.get('iscrowd', 0)) for o, _ in kept], bool)
        # one-hot at the class; a crowd's row is -1 everywhere
        overlaps = np.zeros((n, self.num_classes), np.float32)
        overlaps[np.arange(n), classes] = 1.0
        overlaps[crowds] = -1.0
        return _block(
            self.num_classes,
            np.array([b for _, b in kept], np.float32).reshape(n, 4),
            classes=classes,
            areas=[o.get('area', 0) for o, _ in kept],
            crowds=crowds, gt_inds=np.arange(n), overlaps=overlaps)

    def _merge_proposals(self, roidb, proposal_file, min_size, top_k):
        logger.info('Loading proposals from: %s', proposal_file)
        proposals = load_object(proposal_file)
        id_field = 'indexes' if 'indexes' in proposals else 'ids'
        order = np.argsort(proposals[id_field])
        per_image = [
            (proposals[id_field][i],
             np.asarray(proposals['boxes'][i], np.float32),
             np.asarray(proposals['scores'][i], np.float32).ravel())
            for i in order]
        if len(per_image) != len(roidb):
            raise AssertionError('proposal file covers %d images, roidb '
                                 'has %d' % (len(per_image), len(roidb)))
        for entry, (pid, boxes, scores) in zip(roidb, per_image):
            _validate_proposal_boxes(entry, pid, boxes)
            # one filter after the other: each one's indices are into the
            # boxes the one before kept (the JAX package computes both on
            # the unfiltered boxes, which breaks when a box repeats)
            keep = box_utils.unique_boxes(boxes)
            boxes, scores = boxes[keep], scores[keep]
            keep = box_utils.filter_small_boxes(boxes, min_size)
            boxes, scores = boxes[keep], scores[keep]
            rank = np.argsort(-scores)
            if top_k > 0:
                rank = rank[:top_k]
            _merge_proposal_rows(entry, boxes[rank], scores[rank],
                                 self.num_classes)


def _validate_proposal_boxes(entry, proposal_id, boxes):
    checks = (
        (entry['id'] == proposal_id, 'id mismatch'),
        ((boxes[:, :2] >= 0).all(), 'negative coordinates'),
        ((boxes[:, 2] >= boxes[:, 0]).all() and
         (boxes[:, 3] >= boxes[:, 1]).all(), 'inverted boxes'),
        ((boxes[:, 2] < entry['width']).all() and
         (boxes[:, 3] < entry['height']).all(), 'out of bounds'),
    )
    for ok, what in checks:
        if not ok:
            raise AssertionError('%s: %s' % (what, entry['image']))


def _merge_proposal_rows(entry, boxes, scores, num_classes):
    """Append proposal rows: class 0, overlap row = max IoU against the
    entry's gt boxes scattered into the matched gt's class column."""
    gt_inds = np.where(entry['gt_classes'] > 0)[0]
    n = boxes.shape[0]
    overlap_rows = np.zeros((n, num_classes), np.float32)
    matched_gt = np.full(n, -1, np.int32)
    if len(gt_inds) and n:
        ious = box_utils.bbox_overlaps(
            boxes.astype(np.float32),
            entry['boxes'][gt_inds].astype(np.float32))
        best = ious.argmax(axis=1)
        best_iou = ious.max(axis=1)
        hit = best_iou > 0
        cls_of_best = entry['gt_classes'][gt_inds][best]
        overlap_rows[hit, cls_of_best[hit]] = best_iou[hit]
        matched_gt[hit] = gt_inds[best[hit]]
    _append_rows(entry, _block(num_classes, boxes, obn_scores=scores,
                               gt_inds=matched_gt, overlaps=overlap_rows))


def _suppress_crowd_proposals(entry, crowd_thresh):
    """Mark proposals inside crowd regions with overlap -1 (excluded), by
    intersection over the proposal's area against the crowd boxes."""
    crowd_sel = np.where(entry['is_crowd'] == 1)[0]
    prop_sel = np.where(entry['gt_classes'] == 0)[0]
    if not len(crowd_sel) or not len(prop_sel):
        return
    crowd = entry['boxes'][crowd_sel]
    props = entry['boxes'][prop_sel]
    iw = (np.minimum(props[:, None, 2], crowd[None, :, 2]) -
          np.maximum(props[:, None, 0], crowd[None, :, 0]) + 1).clip(0)
    ih = (np.minimum(props[:, None, 3], crowd[None, :, 3]) -
          np.maximum(props[:, None, 1], crowd[None, :, 1]) + 1).clip(0)
    areas = ((props[:, 2] - props[:, 0] + 1) *
             (props[:, 3] - props[:, 1] + 1))[:, None]
    frac = iw * ih / np.maximum(areas, 1e-12)
    covered = frac.max(axis=1) > crowd_thresh
    entry['gt_overlaps'][prop_sel[covered], :] = -1


def _assign_classes(entry):
    """max_classes / max_overlaps per box, with their consistency checks."""
    ov = entry['gt_overlaps']
    if not ov.shape[0]:
        entry['max_classes'] = np.zeros((0,), np.int32)
        entry['max_overlaps'] = np.zeros((0,), np.float32)
        return
    entry['max_overlaps'] = ov.max(axis=1)
    entry['max_classes'] = ov.argmax(axis=1)
    # background boxes must score 0; any positive-overlap box must carry a
    # foreground class
    bg = entry['max_overlaps'] == 0
    if (entry['max_classes'][bg] != 0).any():
        raise AssertionError('background box with nonzero class')
    if (entry['max_classes'][~bg & (entry['max_overlaps'] > 0)] == 0).any():
        raise AssertionError('foreground overlap assigned to background')
