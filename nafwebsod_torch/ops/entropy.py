"""Spatial-entropy class weighting, the noise-aware loss weighting of
NA-fWebSOD (port of the JAX package's ``ops/entropy.py``).

    J      = RoIIoU(rois)                       (int-truncated, diagonal 1)
    E      = -p * log(p), NaN / Inf -> 0        (p = rois_pred)
    D      = leaky_relu(J @ E, 0.01)
    E_hat  = E * (E / D)                        (0 where D == 0)
    y_norm = cls_prob * (log N - log cls_prob)  (N = number of valid RoIs)
    w_n    = clip(sum_r E_hat / y_norm, 0, 1) * (1 - labels_oh)
    w      = 1 - w_n

Both weights are constants for the gradient. Rows of ``rois_pred`` for
padded RoIs must be exactly 0; the IoU matrix is masked so padded RoIs
neither receive nor contribute overlap, and N counts the valid RoIs only.
The (R, R) @ (R, C) product is a plain ``torch.matmul``.
"""

import torch

from nafwebsod_torch.ops.jbox import roi_iou


@torch.no_grad()
def spatial_entropy_weights(rois_pred, cls_prob, rois, labels_oh,
                            valid_mask=None):
    """rois_pred (R, C), cls_prob (1, C), rois (R, 5), labels_oh (1, C),
    valid_mask (R,) bool or None. Returns (class_weight,
    class_weight_noise), each (1, C)."""
    r = rois_pred.shape[0]
    if valid_mask is None:
        valid = rois_pred.new_ones((r,))
    else:
        valid = valid_mask.to(rois_pred.dtype)
    n_valid = valid.sum()

    j = roi_iou(rois) * valid[:, None] * valid[None, :]

    e = -(rois_pred * torch.log(rois_pred))
    zero = torch.zeros((), dtype=e.dtype, device=e.device)
    e = torch.where(torch.isfinite(e), e, zero) * valid[:, None]

    d = j @ e
    d = torch.where(d >= 0, d, 0.01 * d)
    g = torch.where(d != 0, e / d, zero)
    hat_e_sum = (e * g).sum(dim=0, keepdim=True)

    # the log is guarded at the smallest normal float32, so an underflowed
    # cls_prob == 0 gives a finite y_norm of 0 instead of NaN
    log_y = torch.log(cls_prob.clamp(min=torch.finfo(torch.float32).tiny))
    y_norm = (torch.log(n_valid) - log_y) * cls_prob
    norm = torch.where(y_norm != 0, hat_e_sum / y_norm, zero).clamp(0.0, 1.0)

    class_weight_noise = norm * (1.0 - labels_oh)
    return 1.0 - class_weight_noise, class_weight_noise
