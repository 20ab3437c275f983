"""Device-side box operations (port of the JAX package's ``ops/jbox.py``):
the Detectron ``+1`` IoU matrix and the class-batched greedy NMS with the
cross-class detection cap. Plain torch on the device: the JAX package ran
these through XLA, not a Pallas kernel."""

import torch


def iou_matrix(boxes_a, boxes_b):
    """Pairwise IoU with the Detectron +1 convention. (N,4) x (M,4) -> (N,M)."""
    ax1, ay1, ax2, ay2 = boxes_a[:, None].unbind(-1)                # (N,1)
    bx1, by1, bx2, by2 = boxes_b[None].unbind(-1)                   # (1,M)
    iw = torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1) + 1.0
    ih = torch.minimum(ay2, by2) - torch.maximum(ay1, by1) + 1.0
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    area_a = (ax2 - ax1 + 1.0) * (ay2 - ay1 + 1.0)
    area_b = (bx2 - bx1 + 1.0) * (by2 - by1 + 1.0)
    union = area_a + area_b - inter
    return torch.where(inter > 0, inter / union, torch.zeros_like(inter))


def multiclass_nms_limit(boxes, scores, iou_threshold, score_threshold,
                         max_keep, limit):
    """Class-batched greedy NMS + cross-class detection cap.

    boxes (C, R, 4) per-class xyxy boxes; scores (C, R), padded rows
    ``-inf``. Each of ``max_keep`` steps takes every class's best live box
    (the first on a tie, as ``torch.argmax`` and ``jnp.argmax`` both
    return) and kills the boxes of that class whose IoU with it is
    ``>= iou_threshold``; the winner kills itself by its unit
    self-overlap. With ``limit > 0`` the survivors below the limit-th best
    score over all classes are dropped, ties kept.

    Returns (keep_idx (C, max_keep) int64 into R, keep_scores (C, max_keep)
    float32, keep (C, max_keep) bool), per class in score-descending
    order; dead slots carry idx -1 / score -inf.
    """
    c = scores.shape[0]
    device = scores.device
    neg_inf = torch.tensor(-float('inf'), device=device)
    alive = torch.where(scores > score_threshold, scores, neg_inf)
    cls_idx = torch.arange(c, device=device)
    keep_idx = torch.full((c, max_keep), -1, dtype=torch.long, device=device)
    keep_scores = torch.full((c, max_keep), -float('inf'),
                             dtype=torch.float32, device=device)
    area_b = ((boxes[..., 2] - boxes[..., 0] + 1.0) *
              (boxes[..., 3] - boxes[..., 1] + 1.0))
    for i in range(max_keep):
        best = torch.argmax(alive, dim=1)                             # (C,)
        best_score = alive[cls_idx, best]
        found = torch.isfinite(best_score)
        winner = boxes[cls_idx, best][:, None, :]                  # (C,1,4)
        iw = (torch.minimum(winner[..., 2], boxes[..., 2]) -
              torch.maximum(winner[..., 0], boxes[..., 0]) + 1.0)
        ih = (torch.minimum(winner[..., 3], boxes[..., 3]) -
              torch.maximum(winner[..., 1], boxes[..., 1]) + 1.0)
        inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
        area_w = ((winner[..., 2] - winner[..., 0] + 1.0) *
                  (winner[..., 3] - winner[..., 1] + 1.0))
        ov = inter / (area_w + area_b - inter)
        dead = (ov >= iou_threshold) & found[:, None]
        alive = torch.where(dead, neg_inf, alive)
        keep_idx[:, i] = torch.where(found, best, -1)
        keep_scores[:, i] = best_score
    keep = torch.isfinite(keep_scores)
    if limit > 0 and c * max_keep > limit:
        kth = torch.topk(keep_scores.reshape(-1), limit).values[limit - 1]
        keep = keep & (keep_scores >= kth)
    return keep_idx, keep_scores, keep
