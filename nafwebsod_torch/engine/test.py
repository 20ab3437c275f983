"""Per-image inference (port of the JAX package's ``engine/test.py``, the
plain test protocol: no test-time augmentation, hard NMS, no box voting,
a positive DETECTIONS_PER_IM).

``im_detect_all`` takes the fused route of the JAX package: image blob and
DEDUP_BOXES hashing, the forward, and the class-batched NMS with the
cross-class cap on the device, then detection assembly on the host. The
two-call route (``im_detect_bbox`` then ``box_results_with_nms_and_limit``)
computes the same detections from the expanded per-proposal scores.

With MODEL.MASK_ON, ``im_detect_mask`` runs the mask head on the final
detections (the fcn head per box through RoIAlign, the deeplab head once
per image) and ``segm_results`` pastes the soft masks into the image and
encodes them as COCO RLEs. Mask test-time augmentation is not ported.

The RoI axis is not padded (the JAX package pads it to
``TPU.ROI_PAD_MULTIPLE`` for static XLA shapes and masks the padding out).
"""

import logging
from collections import defaultdict

import numpy as np
import torch

from nafwebsod_torch.core.config import cfg
from nafwebsod_torch.data.minibatch import (pad_image_to_bucket,
                                            prep_im_for_blob)
from nafwebsod_torch.models import vgg16
from nafwebsod_torch.ops import boxes as box_utils
from nafwebsod_torch.ops import jbox
from nafwebsod_torch.utils.segms import mask_to_rle
from nafwebsod_torch.utils.timer import Timer

logger = logging.getLogger(__name__)


def _dedup_scaled_rois(boxes, obn_scores, im_scale):
    """Scale the proposals to the blob, boost the objectness by +1, and
    drop proposals that alias at DEDUP_BOXES resolution (they would inflate
    the RoI-softmax denominator). Returns (rois5, obn, unique_boxes,
    inv_index); ``inv_index`` (None when dedup is off) maps the original
    rows onto the unique set."""
    rois5 = np.hstack([np.zeros((boxes.shape[0], 1), np.float32),
                       (boxes * im_scale).astype(np.float32)])
    obn = np.add(obn_scores, 1.0).astype(np.float32).reshape(-1, 1)
    inv_index = None
    if cfg.DEDUP_BOXES > 0:
        v = np.array([1, 1e3, 1e6, 1e9, 1e12])
        hashes = np.round(rois5 * cfg.DEDUP_BOXES).dot(v)
        _, index, inv_index = np.unique(hashes, return_index=True,
                                        return_inverse=True)
        rois5, obn, boxes = rois5[index], obn[index], boxes[index]
    return rois5, obn, boxes, inv_index


def _forward(model, im, boxes, obn_scores, target_scale, target_max_size):
    """Blob prep, dedup and forward_test. Returns (per-unique-RoI scores
    (R, num_classes) float32 on the device, unique boxes, inv_index,
    im_scale)."""
    device = model.device
    im_blob, im_scale = prep_im_for_blob(
        im, cfg.PIXEL_MEANS, target_scale, target_max_size, cfg.PIXEL_STDS,
        device=device)
    rois5, obn, boxes_u, inv_index = _dedup_scaled_rois(
        boxes, obn_scores, im_scale)
    im_in = pad_image_to_bucket(im_blob, cfg.TPU.SIZE_BUCKET_MULTIPLE)
    # the blob's true extent inside the bucket-padded canvas: the context
    # head clips its rings there
    out = model.forward_test(im_in[None], torch.from_numpy(rois5).to(device),
                             torch.from_numpy(obn).to(device),
                             im_hw=im_blob.shape[:2])
    return out['scores'].float(), boxes_u, inv_index, im_scale


def _nms_limit(scores, boxes, device):
    """multiclass_nms_limit over the foreground classes of (R, C) scores
    with (R, C, 4) per-class boxes (numpy). Returns numpy
    (idx, vals, keep), each (C - 1, K)."""
    r = scores.shape[0]
    limit = int(cfg.TEST.DETECTIONS_PER_IM)
    idx, vals, keep = jbox.multiclass_nms_limit(
        torch.as_tensor(boxes, device=device).transpose(0, 1)[1:],
        torch.as_tensor(scores, device=device).T[1:],
        float(cfg.TEST.NMS), float(cfg.TEST.SCORE_THRESH),
        max_keep=min(limit, r), limit=limit)
    return idx.cpu().numpy(), vals.cpu().numpy(), keep.cpu().numpy()


def _assemble_cls_boxes(boxes, idx, vals, keep):
    """(C-1, K) NMS outputs over shared proposals -> the per-class det
    list (index 0 = background, empty)."""
    cls_boxes = [[]]
    for j in range(1, cfg.MODEL.NUM_CLASSES):
        rows = idx[j - 1][keep[j - 1]]
        cls_boxes.append(np.concatenate(
            [boxes[rows], vals[j - 1][keep[j - 1]][:, None]],
            axis=1).astype(np.float32))
    return cls_boxes


def im_detect_fused(model, im, boxes, obn_scores):
    """Per-image detection on the plain protocol: forward on the unique
    proposals, then NMS and the cap on the device. Duplicates carry
    identical boxes and scores, so NMS on the unique set gives the same
    detections as on the expanded set. Returns the per-class det list."""
    scores, boxes_u, _, _ = _forward(model, im, boxes, obn_scores,
                                     cfg.TEST.SCALE, cfg.TEST.MAX_SIZE)
    boxes_u = boxes_u.astype(np.float32)
    c = scores.shape[1]
    tiled = torch.as_tensor(boxes_u, device=scores.device)[:, None].expand(
        -1, c, 4)
    idx, vals, keep = _nms_limit(scores, tiled, scores.device)
    return _assemble_cls_boxes(boxes_u, idx, vals, keep)


def im_detect_bbox(model, im, target_scale, target_max_size, boxes,
                   obn_scores):
    """Scores of every given proposal. Returns (scores (R, num_classes)
    with the background column, pred_boxes (R, 4 * num_classes) -- the
    proposals tiled per class, as WSL has no box regression -- and
    im_scale), all numpy."""
    scores, _, inv_index, im_scale = _forward(
        model, im, boxes, obn_scores, target_scale, target_max_size)
    scores = scores.cpu().numpy()
    if inv_index is not None:
        scores = scores[inv_index.reshape(-1)]
    return scores, np.tile(boxes, (1, scores.shape[1])), im_scale


def _cap_total_detections(dets, limit):
    """Cross-class DETECTIONS_PER_IM cap: threshold at the limit-th best
    score, keeping ties."""
    pool = np.concatenate([d[:, 4] for d in dets.values()])
    if limit <= 0 or pool.size <= limit:
        return dets
    cut = np.partition(pool, -limit)[-limit]
    return {j: d[d[:, 4] >= cut] for j, d in dets.items()}


def box_results_with_nms_and_limit(scores, boxes, device):
    """Per-class score gate, greedy NMS and the cross-class cap for
    (R, num_classes) scores and (R, 4 * num_classes) boxes, on ``device``.
    Returns (scores_flat, boxes_flat, cls_boxes)."""
    num_classes = cfg.MODEL.NUM_CLASSES
    r = scores.shape[0]
    if r == 0:
        dets = {j: np.zeros((0, 5), np.float32)
                for j in range(1, num_classes)}
    else:
        bx = boxes.reshape(r, num_classes, 4).astype(np.float32)
        idx, vals, keep = _nms_limit(scores.astype(np.float32), bx, device)
        dets = {j: np.concatenate(
                    [bx[idx[j - 1][keep[j - 1]], j],
                     vals[j - 1][keep[j - 1]][:, None]],
                    axis=1).astype(np.float32)
                for j in range(1, num_classes)}
    dets = _cap_total_detections(dets, int(cfg.TEST.DETECTIONS_PER_IM))
    merged = np.concatenate([dets[j] for j in range(1, num_classes)])
    cls_boxes = [[]] + [dets[j] for j in range(1, num_classes)]
    return merged[:, 4], merged[:, :4], cls_boxes


def check_protocol():
    """Raise for a test protocol the port does not run yet."""
    unported = [k for k, on in (
        ('TEST.BBOX_AUG.ENABLED', cfg.TEST.BBOX_AUG.ENABLED),
        ('TEST.SOFT_NMS.ENABLED', cfg.TEST.SOFT_NMS.ENABLED),
        ('TEST.BBOX_VOTE.ENABLED', cfg.TEST.BBOX_VOTE.ENABLED),
        ('TEST.MASK_AUG.ENABLED', cfg.TEST.MASK_AUG.ENABLED),
        ('TEST.DETECTIONS_PER_IM <= 0',
         int(cfg.TEST.DETECTIONS_PER_IM) <= 0),
        ('TEST.PRECOMPUTED_PROPOSALS False',
         not cfg.TEST.PRECOMPUTED_PROPOSALS)) if on]
    if unported:
        raise NotImplementedError('not ported yet: ' + ', '.join(unported))


def _final_boxes(cls_boxes):
    """The per-class NMS survivors flattened back to (R, 4), and the count
    of each foreground class."""
    per_cls = [np.asarray(cls_boxes[j]).reshape(-1, 5)
               for j in range(1, cfg.MODEL.NUM_CLASSES)]
    boxes = (np.vstack([d[:, :4] for d in per_cls])
             if per_cls else np.zeros((0, 4), np.float32))
    return boxes, [len(d) for d in per_cls]


def resize_bilinear(src, out_h, out_w):
    """``cv2.resize(src, (out_w, out_h))`` of a float32 (h, w) array with
    its default bilinear interpolation: half-pixel centres at the ratio
    source / output per axis, clamped at the border, no antialiasing."""
    src = torch.from_numpy(np.ascontiguousarray(src, dtype=np.float32))
    h, w = src.shape
    out = torch.ops.aten.upsample_bilinear2d(
        src[None, None], [int(out_h), int(out_w)], False,
        out_h / float(h), out_w / float(w))
    return out[0, 0].numpy()


def segm_results_deeplab(cls_boxes, masks, ref_boxes, im_h, im_w):
    """Per-detection RLEs from the deeplab head's image-level grid
    ``masks`` (1, h, w, C), channel j the soft mask of class j: the grid is
    resized to the image and binarised at MRCNN.THRESH_BINARIZE, and each
    detection keeps the pixels inside its box."""
    num_classes = cfg.MODEL.NUM_CLASSES
    cls_segms = [[] for _ in range(num_classes)]
    mask_ind = 0
    for j in range(1, num_classes):
        n_dets = len(np.asarray(cls_boxes[j]).reshape(-1, 5))
        segms = []
        if n_dets:
            cls_ch = j if cfg.MRCNN.CLS_SPECIFIC_MASK else 0
            soft = resize_bilinear(masks[0, :, :, cls_ch], im_h, im_w)
            binarized = (soft > cfg.MRCNN.THRESH_BINARIZE).astype(np.uint8)
        for _ in range(n_dets):
            box = ref_boxes[mask_ind]
            im_mask = np.zeros((im_h, im_w), np.uint8)
            x0, x1 = int(max(box[0], 0)), int(min(box[2] + 1, im_w))
            y0, y1 = int(max(box[1], 0)), int(min(box[3] + 1, im_h))
            if x1 > x0 and y1 > y0:
                im_mask[y0:y1, x0:x1] = binarized[y0:y1, x0:x1]
            segms.append(mask_to_rle(im_mask))
            mask_ind += 1
        cls_segms[j] = segms
    return cls_segms


def segm_results(cls_boxes, masks, ref_boxes, im_h, im_w):
    """Per-detection RLEs from the fcn head's per-RoI soft masks
    (R, M, M, C): each mask, padded by one zero pixel against border
    artifacts, is resized to its box expanded by (M + 2) / M, binarised at
    MRCNN.THRESH_BINARIZE and pasted into the image. The deeplab head's
    image-level grid goes to ``segm_results_deeplab``. Returns
    cls_segms[class] = [RLE per detection], in ``cls_boxes``' order."""
    if 'deeplab' in cfg.MRCNN.ROI_MASK_HEAD:
        return segm_results_deeplab(cls_boxes, masks, ref_boxes, im_h, im_w)
    num_classes = cfg.MODEL.NUM_CLASSES
    cls_segms = [[] for _ in range(num_classes)]
    mask_ind = 0
    m = masks.shape[1]
    scale = (m + 2.0) / m
    ref_boxes = box_utils.expand_boxes(ref_boxes, scale).astype(np.int32)
    padded = np.zeros((m + 2, m + 2), np.float32)
    for j in range(1, num_classes):
        segms = []
        for _ in range(len(np.asarray(cls_boxes[j]).reshape(-1, 5))):
            cls_ch = j if cfg.MRCNN.CLS_SPECIFIC_MASK else 0
            padded[1:-1, 1:-1] = masks[mask_ind, :, :, cls_ch]
            box = ref_boxes[mask_ind]
            w = max(box[2] - box[0] + 1, 1)
            h = max(box[3] - box[1] + 1, 1)
            mask = resize_bilinear(padded, h, w)
            mask = (mask > cfg.MRCNN.THRESH_BINARIZE).astype(np.uint8)
            im_mask = np.zeros((im_h, im_w), np.uint8)
            x0, x1 = max(box[0], 0), min(box[2] + 1, im_w)
            y0, y1 = max(box[1], 0), min(box[3] + 1, im_h)
            if x1 > x0 and y1 > y0:
                im_mask[y0:y1, x0:x1] = mask[(y0 - box[1]):(y1 - box[1]),
                                             (x0 - box[0]):(x1 - box[0])]
            segms.append(mask_to_rle(im_mask))
            mask_ind += 1
        cls_segms[j] = segms
    return cls_segms


def _mask_forward(model, im, boxes, target_scale, target_max_size):
    """Soft masks for the given original-image boxes at one image scale,
    numpy float32: (R, M, M, C) from the fcn head (rois = boxes x
    im_scale), or the deeplab head's one (1, h, w, C) grid, cropped to the
    blob's true extent so that the bucket padding never reaches the
    per-detection resize."""
    device = model.device
    im_blob, im_scale = prep_im_for_blob(
        im, cfg.PIXEL_MEANS, target_scale, target_max_size, cfg.PIXEL_STDS,
        device=device)
    im_in = pad_image_to_bucket(im_blob, cfg.TPU.SIZE_BUCKET_MULTIPLE)
    if model.spec.is_deeplab:
        grid = model.forward_deeplab_masks(im_in[None])
        s = vgg16.spatial_scale(model.spec.dilation)
        gh = max(int(np.ceil(im_blob.shape[0] * s)), 1)
        gw = max(int(np.ceil(im_blob.shape[1] * s)), 1)
        return grid[:, :gh, :gw, :].cpu().numpy()
    rois5 = np.hstack([np.zeros((len(boxes), 1), np.float32),
                       boxes * im_scale]).astype(np.float32)
    return model.forward_masks(
        im_in[None], torch.from_numpy(rois5).to(device)).cpu().numpy()


def im_detect_mask(model, im, cls_boxes):
    """The mask head on the final detections. Returns cls_segms: per class
    one RLE per detection."""
    boxes, _ = _final_boxes(cls_boxes)
    if len(boxes) == 0:
        return [[] for _ in range(cfg.MODEL.NUM_CLASSES)]
    masks = _mask_forward(model, im, boxes, cfg.TEST.SCALE,
                          cfg.TEST.MAX_SIZE)
    return segm_results(cls_boxes, masks, boxes, im.shape[0], im.shape[1])


def im_detect_all(model, im, box_proposals, obn_scores, timers=None):
    """Detections of one (H, W, 3) uint8 BGR image from its proposals
    (R, 4) and objectness (R,) or (R, 1). Returns (cls_boxes, cls_segms,
    None): the per-class (n, 5) [x1, y1, x2, y2, score] arrays, index 0
    empty; with MODEL.MASK_ON the per-class lists of one RLE per detection
    (None otherwise); the keypoint slot of the JAX package's result is not
    ported."""
    check_protocol()
    if timers is None:
        timers = defaultdict(Timer)
    timers['im_detect_bbox'].tic()
    cls_boxes = im_detect_fused(model, im, box_proposals, obn_scores)
    timers['im_detect_bbox'].toc()
    cls_segms = None
    if model.spec.mask_on:
        timers['im_detect_mask'].tic()
        cls_segms = im_detect_mask(model, im, cls_boxes)
        timers['im_detect_mask'].toc()
    return cls_boxes, cls_segms, None
