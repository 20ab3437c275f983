"""CPG (class-peak-gradient) saliency and CSC (contrastive spatial
constraint), a port of the JAX package's ``ops/cpg.py``.

  * ``cpg_maps``: per ground-truth class whose image-level score is in
    [tau, 1), the channel max of |d cls_prob_c / d image|, normalised to
    max 1; a map whose max is exactly 0 or 1 is dropped. One backward pass
    per active class (``torch.autograd.grad`` with the graph retained);
    inactive classes run none.
  * ``csc_weights``: binarise a map at ``fg_threshold``, integral image by
    two cumulative sums, per-RoI contrastive score = frame-ring density
    minus context-ring density with sqrt-area normalisation, per-class
    normalisation to [-1, 1] (malformed and padded RoIs give -1), then the
    confidence blend W = pred * W + (1 - pred).
  * ``csc_constraint``: ``polar=True`` keeps the positive weights,
    ``polar=False`` the negated negative ones; the weight is a constant
    for the gradient.
"""

import torch

KMIN_SCORE = -1e20


def select_gt_classes(labels_oh, max_gt):
    """The first ``max_gt`` ground-truth classes of (1, C) labels in
    ascending order, padded with -1. Returns a list of ``max_gt`` ints."""
    gt = torch.nonzero(labels_oh[0] >= 0.5).reshape(-1).tolist()[:max_gt]
    return gt + [-1] * (max_gt - len(gt))


def cpg_maps(cls_prob, image, labels_oh, tau=0.7, max_gt=4):
    """Saliency maps for up to ``max_gt`` ground-truth classes.

    cls_prob: (1, C) image-level scores whose graph reaches ``image``
    (1, H, W, 3), a leaf that requires grad; the graph is kept for the
    caller. Returns (maps (max_gt, H, W) float32, class_idx list of
    max_gt ints with -1 padding, keep (max_gt,) bool tensor); all
    constants for the gradient."""
    idx = select_gt_classes(labels_oh, max_gt)
    pred = cls_prob[0].detach()
    scores = pred.tolist()
    h, w = image.shape[1:3]
    maps = torch.zeros((max_gt, h, w), dtype=torch.float32,
                       device=image.device)
    active = [ci >= 0 and scores[ci] >= tau for ci in idx]
    for k, ci in enumerate(idx):
        if not active[k]:
            continue
        grad, = torch.autograd.grad(cls_prob[0, ci], image,
                                    retain_graph=True)
        maps[k] = grad[0].abs().amax(dim=-1).float()

    # CPGScale: normalise to max 1; drop a map whose max is 0 or 1
    max_val = maps.amax(dim=(1, 2))
    keep = (torch.tensor(active, device=image.device) &
            (max_val != 0.0) & (max_val != 1.0))
    scale = torch.where(max_val > 0, 1.0 / max_val.clamp(min=1e-20),
                        torch.zeros_like(max_val))
    maps = maps * scale[:, None, None]
    maps = torch.where(keep[:, None, None], maps, torch.zeros_like(maps))
    return maps, idx, keep


def _integral(binary):
    """Inclusive 2-D integral image."""
    return torch.cumsum(torch.cumsum(binary, dim=0), dim=1)


def _rect_sum(ii, y0, x0, y1, x1):
    """Sums over [y0..y1] x [x0..x1] inclusive from an integral image, with
    the reference op's guarded corner lookups. The corners are (R,) int64."""
    h, w = ii.shape
    zero = torch.zeros((), dtype=ii.dtype, device=ii.device)
    y1c = y1.clamp(0, h - 1)
    x1c = x1.clamp(0, w - 1)
    y0m = (y0 - 1).clamp(0, h - 1)
    x0m = (x0 - 1).clamp(0, w - 1)
    a1 = ii[y1c, x1c]
    a2 = torch.where(x0 - 1 >= 0, ii[y1c, x0m], zero)
    a3 = torch.where(y0 - 1 >= 0, ii[y0m, x1c], zero)
    a4 = torch.where((x0 - 1 >= 0) & (y0 - 1 >= 0), ii[y0m, x0m], zero)
    return a1 - a2 - a3 + a4


def _round(x):
    """Half to even, as ``jnp.round`` (RoIPoolF rounds half away)."""
    return torch.round(x).long()


def csc_scores_one_class(cpg_map, rois, fg_threshold=0.1, context_scale=1.8,
                         area_sqrt=True):
    """Per-RoI contrastive scores for one (H, W) class map. rois: (R, 5) in
    image coordinates. Returns (R,) raw scores, KMIN_SCORE for malformed
    RoIs."""
    h, w = cpg_map.shape
    ii = _integral((cpg_map >= fg_threshold).float())

    ws, hs = _round(rois[:, 1]), _round(rois[:, 2])
    we, he = _round(rois[:, 3]), _round(rois[:, 4])
    ok = (ws >= 0) & (hs >= 0) & (ws < we) & (hs < he) & (we < w) & (he < h)

    width_roi = (we - ws).float()
    height_roi = (he - hs).float()
    wc = (we + ws).float() / 2.0
    hc = (he + hs).float() / 2.0
    wi, hi = width_roi / context_scale, height_roi / context_scale
    wo, ho = width_roi * context_scale, height_roi * context_scale

    ws_i, hs_i = _round(wc - wi / 2), _round(hc - hi / 2)
    we_i, he_i = _round(wc + wi / 2), _round(hc + hi / 2)
    ws_o = _round((wc - wo / 2).clamp(min=0.0))
    hs_o = _round((hc - ho / 2).clamp(min=0.0))
    we_o = _round((wc + wo / 2).clamp(max=w - 1.0))
    he_o = _round((hc + ho / 2).clamp(max=h - 1.0))

    area = (he - hs + 1) * (we - ws + 1)
    area_in = (he_i - hs_i + 1) * (we_i - ws_i + 1)
    area_out = (he_o - hs_o + 1) * (we_o - ws_o + 1)
    area_frame = (area - area_in).float().clamp(min=1.0)
    area_ctx = (area_out - area).float().clamp(min=1.0)

    sum_roi = _rect_sum(ii, hs, ws, he, we)
    sum_in = _rect_sum(ii, hs_i, ws_i, he_i, we_i)
    sum_out = _rect_sum(ii, hs_o, ws_o, he_o, we_o)

    sum_frame = sum_roi - sum_in
    sum_ctx = sum_out - sum_roi
    if area_sqrt:
        score = (sum_frame / torch.sqrt(area_frame) -
                 sum_ctx / torch.sqrt(area_ctx))
    else:
        score = sum_frame / area_frame - sum_ctx / area_ctx
    return torch.where(ok, score, score.new_full((), KMIN_SCORE))


def _normalize_class(scores):
    """Per-class normalisation to [-1, 1]."""
    is_min = scores == KMIN_SCORE
    zero = torch.zeros_like(scores)
    max_v = scores.max().clamp(min=0.0)
    min_v = torch.where(is_min, zero, scores).min().clamp(max=0.0)
    neg_one = -torch.ones_like(scores)
    pos_neg = torch.where(is_min, neg_one, torch.where(
        scores > 0, scores / max_v, scores / (-min_v)))
    pos_only = torch.where(is_min, neg_one, scores / max_v)
    return torch.where((max_v > 0) & (min_v < 0), pos_neg,
                       torch.where((max_v > 0) & (min_v == 0), pos_only,
                                   torch.ones_like(scores)))


@torch.no_grad()
def csc_weights(maps, class_idx, class_keep, rois, labels_oh, cls_prob,
                fg_threshold=0.1, context_scale=1.8, valid_mask=None):
    """Full CSC: the (R, C) weights W (1 where no map applies) and
    (labels_pos, labels_neg) = (labels_oh, zeros). ``class_idx`` is a list
    of ints (-1 = padding), ``class_keep`` a bool tensor of the same
    length."""
    r = rois.shape[0]
    c = labels_oh.shape[1]
    w_full = torch.ones((r, c), dtype=torch.float32, device=rois.device)
    for k, keep in enumerate(class_keep.tolist()):
        if not keep:  # a dropped or padded slot leaves its column at 1
            continue
        ci = class_idx[k]
        raw = csc_scores_one_class(maps[k], rois, fg_threshold,
                                   context_scale)
        if valid_mask is not None:
            raw = torch.where(valid_mask, raw, raw.new_full((), KMIN_SCORE))
        pred = cls_prob[0, ci]
        w_full[:, ci] = pred * _normalize_class(raw) + (1.0 - pred)
    return w_full, labels_oh, torch.zeros_like(labels_oh)


def csc_constraint(rois_pred, w, polar=True):
    """CSCConstraint: clip(W) * rois_pred, W a constant."""
    w = w.detach()
    w_clipped = w.clamp(min=0.0) if polar else -w.clamp(max=0.0)
    return rois_pred * w_clipped
