"""The COCO-protocol box evaluator (the port's own copy of the box path of
the JAX package's ``data/coco_evaluator.py``; numpy, no pycocotools):
AP@[.5:.95], AP50, AP75 and APs / APm / APl, with greedy score-ordered
matching per (image, category), crowd and ignore handling, maxDets 100
and 101-point precision interpolation. The segm and keypoint tasks are
not ported (``task_evaluation`` raises for them).
"""

import logging

import numpy as np

logger = logging.getLogger(__name__)

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    'all': (0.0, 1e10),
    'small': (0.0, 32.0 ** 2),
    'medium': (32.0 ** 2, 96.0 ** 2),
    'large': (96.0 ** 2, 1e10),
}
MAX_DETS = 100


def _iou_xywh(dets, gts, iscrowd):
    """IoU between det and gt boxes in xywh; crowd gts use intersection /
    det-area (pycocotools semantics)."""
    n, m = len(dets), len(gts)
    ious = np.zeros((n, m))
    for j, g in enumerate(gts):
        gx1, gy1, gw, gh = g
        gx2, gy2 = gx1 + gw, gy1 + gh
        garea = gw * gh
        for i, d in enumerate(dets):
            dx1, dy1, dw, dh = d
            dx2, dy2 = dx1 + dw, dy1 + dh
            darea = dw * dh
            iw = min(dx2, gx2) - max(dx1, gx1)
            ih = min(dy2, gy2) - max(dy1, gy1)
            if iw <= 0 or ih <= 0:
                continue
            inter = iw * ih
            union = darea if iscrowd[j] else darea + garea - inter
            ious[i, j] = inter / union
    return ious


def _evaluate_img(dets, det_scores, gts, gt_ignore, iscrowd, area_rng):
    """Match one image's xywh dets to its xywh gts across all IoU
    thresholds. Returns (dt_matches, dt_ignore, dt_scores, n_gt) where dt_*
    have shape (T, D)."""
    gt_areas = gts[:, 2] * gts[:, 3] if len(gts) else np.zeros(0)
    gt_ig = gt_ignore | (gt_areas < area_rng[0]) | (gt_areas > area_rng[1])
    # sort gts: unignored first (pycocotools order)
    gt_order = np.argsort(gt_ig, kind='mergesort')
    if len(gts):
        gts = gts[gt_order]
        gt_ig = gt_ig[gt_order]
        crowd = iscrowd[gt_order]
    else:
        crowd = iscrowd

    # sort dets by score desc, cap maxDets
    order = np.argsort(-det_scores, kind='mergesort')[:MAX_DETS]
    if len(dets):
        dets = dets[order]
        det_scores = det_scores[order]

    T = len(IOU_THRS)
    D = len(dets)
    G = len(gts)
    dtm = np.zeros((T, D), dtype=np.int64)
    dt_ig = np.zeros((T, D), dtype=bool)
    if D and G:
        ious = _iou_xywh(dets, gts, crowd)
        for ti, t in enumerate(IOU_THRS):
            gtm = np.zeros(G, dtype=bool)
            for di in range(D):
                best_iou = min(t, 1 - 1e-10)
                best_g = -1
                for gi in range(G):
                    if gtm[gi] and not crowd[gi]:
                        continue
                    # stop at ignored gts once a real match was found
                    if best_g > -1 and not gt_ig[best_g] and gt_ig[gi]:
                        break
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    best_g = gi
                if best_g == -1:
                    continue
                dtm[ti, di] = 1
                dt_ig[ti, di] = gt_ig[best_g]
                gtm[best_g] = True
    # unmatched dets outside the area range are ignored
    if D:
        det_areas = dets[:, 2] * dets[:, 3]
        out_rng = (det_areas < area_rng[0]) | (det_areas > area_rng[1])
        dt_ig = dt_ig | ((dtm == 0) & out_rng[None, :])
    n_gt = int(np.sum(~gt_ig))
    return dtm, dt_ig, det_scores, n_gt


def evaluate_bbox(gt_by_img_cat, det_by_img_cat, categories, image_ids):
    """COCO box metrics.

    gt_by_img_cat[(img, cat)] = dict(boxes (G, 4) xywh, ignore (G,),
        crowd (G,))
    det_by_img_cat[(img, cat)] = dict(boxes (D, 4) xywh, scores (D,))
    Returns {'AP', 'AP50', 'AP75', 'APs', 'APm', 'APl'} (a range without
    ground truth has no key; no ground truth at all gives AP -1).
    """
    results = {}
    for area_name, area_rng in AREA_RANGES.items():
        # per-category accumulation
        ap_per_cat = []
        for cat in categories:
            dtm_all, dtig_all, scores_all = [], [], []
            n_gt_total = 0
            for img in image_ids:
                gt = gt_by_img_cat.get((img, cat))
                dt = det_by_img_cat.get((img, cat))
                g_boxes = gt['boxes'] if gt else np.zeros((0, 4))
                g_ignore = gt['ignore'] if gt else np.zeros(0, bool)
                g_crowd = gt['crowd'] if gt else np.zeros(0, bool)
                d_boxes = dt['boxes'] if dt else np.zeros((0, 4))
                d_scores = dt['scores'] if dt else np.zeros(0)
                if len(g_boxes) == 0 and len(d_boxes) == 0:
                    continue
                dtm, dtig, ds, n_gt = _evaluate_img(
                    d_boxes, d_scores, g_boxes, g_ignore.astype(bool),
                    g_crowd.astype(bool), area_rng)
                dtm_all.append(dtm)
                dtig_all.append(dtig)
                scores_all.append(ds)
                n_gt_total += n_gt
            if n_gt_total == 0:
                continue
            if dtm_all:
                dtm = np.concatenate(dtm_all, axis=1)
                dtig = np.concatenate(dtig_all, axis=1)
                scores = np.concatenate(scores_all)
            else:
                dtm = np.zeros((len(IOU_THRS), 0), np.int64)
                dtig = np.zeros((len(IOU_THRS), 0), bool)
                scores = np.zeros(0)
            order = np.argsort(-scores, kind='mergesort')
            dtm, dtig = dtm[:, order], dtig[:, order]
            ap_t = np.zeros(len(IOU_THRS))
            for ti in range(len(IOU_THRS)):
                keep = ~dtig[ti]
                tps = (dtm[ti][keep] == 1).astype(np.float64)
                fps = (dtm[ti][keep] == 0).astype(np.float64)
                tp = np.cumsum(tps)
                fp = np.cumsum(fps)
                rc = tp / n_gt_total
                pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
                # precision envelope + 101-pt interpolation
                for i in range(len(pr) - 1, 0, -1):
                    pr[i - 1] = max(pr[i - 1], pr[i])
                inds = np.searchsorted(rc, RECALL_THRS, side='left')
                q = np.zeros(len(RECALL_THRS))
                for ri, pi in enumerate(inds):
                    if pi < len(pr):
                        q[ri] = pr[pi]
                ap_t[ti] = np.mean(q)
            ap_per_cat.append(ap_t)
        if ap_per_cat:
            ap_arr = np.stack(ap_per_cat)  # (C, T)
            if area_name == 'all':
                results['AP'] = float(np.mean(ap_arr))
                results['AP50'] = float(np.mean(ap_arr[:, 0]))
                results['AP75'] = float(np.mean(ap_arr[:, 5]))
            else:
                results['AP' + area_name[0]] = float(np.mean(ap_arr))
        elif area_name == 'all':
            results.update({'AP': -1.0, 'AP50': -1.0, 'AP75': -1.0})
    return results


def evaluate_boxes(json_dataset, all_boxes, output_dir,
                   image_ids=None):
    """Evaluate class-indexed detections against a JsonDataset's gt."""
    roidb = json_dataset.get_roidb(gt=True)
    if image_ids is None:
        image_ids = [e['id'] for e in roidb]
    else:
        # detection-time ids: all_boxes[cls][i] is positionally aligned
        # with the roidb THE ENGINE iterated, which the train-set no-class
        # filter can make differ from the gt-only rebuild above (gt lookups
        # below are id-keyed, so extra/missing gt entries resolve correctly)
        image_ids = list(image_ids)
    gt_by_img_cat = {}
    for e in roidb:
        for cls in np.unique(e['gt_classes'][e['gt_classes'] > 0]):
            sel = e['gt_classes'] == cls
            boxes = e['boxes'][sel]
            xywh = np.stack([boxes[:, 0], boxes[:, 1],
                             boxes[:, 2] - boxes[:, 0] + 1,
                             boxes[:, 3] - boxes[:, 1] + 1], axis=1)
            gt_by_img_cat[(e['id'], int(cls))] = {
                'boxes': xywh,
                'ignore': e['is_crowd'][sel].astype(bool),
                'crowd': e['is_crowd'][sel].astype(bool),
            }
    det_by_img_cat = {}
    num_classes = len(json_dataset.classes)
    for cls in range(1, num_classes):
        for i, img_id in enumerate(image_ids):
            dets = all_boxes[cls][i]
            if isinstance(dets, list) or len(dets) == 0:
                continue
            xywh = np.stack([dets[:, 0], dets[:, 1],
                             dets[:, 2] - dets[:, 0] + 1,
                             dets[:, 3] - dets[:, 1] + 1], axis=1)
            det_by_img_cat[(img_id, cls)] = {
                'boxes': xywh, 'scores': dets[:, 4],
            }
    res = evaluate_bbox(gt_by_img_cat, det_by_img_cat,
                        list(range(1, num_classes)), image_ids)
    logger.info('COCO bbox results: %s', res)
    return res
