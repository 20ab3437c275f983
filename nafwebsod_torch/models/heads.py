"""WSDDN / noise-aware webly heads (port of the JAX package's
``models/heads.py``, the parts on the flagship's inference path).

Parameters are float32 masters cast to the activation dtype at each use,
as in the JAX package. Hidden fc layers run in the activation dtype; the
fc8 logit layers always produce float32: for bf16 activations the products
of the bf16 values are summed in float32 (the JAX package's
``preferred_element_type=float32``), which here is a float32 GEMM on the
bf16 activations and the bf16-rounded weights, not a bf16 GEMM upcast
afterwards.

Not ported: the ``fused`` / ``fused_fc7`` / stacked-tower variants of the
JAX noise head. They are TPU layout experiments that compute the same
function.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from nafwebsod_torch.ops import roi_pool as roi_ops


def _xavier_(weight, generator):
    """Caffe2 XavierFill: uniform(-a, a), a = sqrt(3 / fan_in)."""
    a = math.sqrt(3.0 / weight.shape[1])
    weight.uniform_(-a, a, generator=generator)


def fc(x, layer, out_dtype=None):
    """``x @ W.T + b`` in the activation dtype, or in ``out_dtype``
    (float32) for the logit layers."""
    w = layer.weight.to(x.dtype)
    if out_dtype is not None and out_dtype != x.dtype:
        return (F.linear(x.to(out_dtype), w.to(out_dtype))
                + layer.bias.to(out_dtype))
    return F.linear(x, w) + layer.bias.to(x.dtype)


class FcTower(nn.Module):
    """fc6 -> relu -> dropout -> fc7 -> relu -> dropout (dropout 0.5 only
    when ``train``)."""

    def __init__(self, dim_in, hidden, device=None):
        super().__init__()
        self.fc6 = nn.Linear(dim_in, hidden, device=device)
        self.fc7 = nn.Linear(hidden, hidden, device=device)

    def forward(self, x, train=False):
        x = F.dropout(F.relu(fc(x, self.fc6)), 0.5, train)
        return F.dropout(F.relu(fc(x, self.fc7)), 0.5, train)


def roi_transform(feat, rois, obn_scores, spatial_scale, resolution=7,
                  freeze_body=True):
    """RoIPoolF + RoIFeatureBoost (+ no gradient into a frozen body),
    flattened in C*H*W order like the reference's NCHW blobs, so reference
    fc6 weights apply without a transpose. feat: (H, W, C)."""
    pooled = roi_ops.roi_pool(feat, rois, resolution, resolution,
                              spatial_scale)
    pooled = roi_ops.roi_feature_boost(pooled, obn_scores)
    if freeze_body:
        pooled = pooled.detach()
    return pooled.permute(0, 3, 1, 2).reshape(pooled.shape[0], -1)


def _two_stream(fc8c, fc8d, valid_mask):
    """Softmax over classes x masked softmax over RoIs -> rois_pred."""
    alpha_cls = torch.softmax(fc8c, dim=1)
    if valid_mask is not None:
        fc8d = torch.where(valid_mask[:, None], fc8d,
                           torch.finfo(fc8d.dtype).min)
    rois_pred = alpha_cls * torch.softmax(fc8d, dim=0)
    if valid_mask is not None:
        rois_pred = rois_pred * valid_mask[:, None]
    return rois_pred


class NoiseHead(nn.Module):
    """The noise-aware 2fc head and its outputs: a clean fc6/fc7 tower and
    a noisy one over the same boosted RoI features, the WSDDN fc8c/fc8d
    two-stream layers on the clean tower, and the noisy residual logits
    (``webly_heads.add_VGG16_roi_2fc_noise_head`` + ``webly_outputs``)."""

    def __init__(self, num_classes, roi_feat_dim=512 * 7 * 7, hidden=4096,
                 device=None):
        super().__init__()
        c = num_classes - 1
        self.clean = FcTower(roi_feat_dim, hidden, device)
        self.noisy = FcTower(roi_feat_dim, hidden, device)
        self.fc8c = nn.Linear(hidden, c, device=device)
        self.fc8d = nn.Linear(hidden, c, device=device)
        self.noisy_fc8c = nn.Linear(hidden, c, device=device)
        self.noisy_fc8d = nn.Linear(hidden, c, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Xavier-uniform weights, zero biases."""
        for layer in self.modules():
            if isinstance(layer, nn.Linear):
                _xavier_(layer.weight, generator)
                layer.bias.zero_()

    def towers(self, roi_feat, train=False):
        return self.clean(roi_feat, train), self.noisy(roi_feat, train)

    def wsl_outputs(self, fc7, valid_mask=None):
        fc8c = fc(fc7, self.fc8c, torch.float32)
        fc8d = fc(fc7, self.fc8d, torch.float32)
        return {'fc8c': fc8c, 'fc8d': fc8d,
                'rois_pred': _two_stream(fc8c, fc8d, valid_mask)}

    def webly_outputs(self, fc7_clean, fc7_noisy, valid_mask=None):
        out = self.wsl_outputs(fc7_clean, valid_mask)
        fc8c_noise = out['fc8c'] + fc(fc7_noisy, self.noisy_fc8c,
                                      torch.float32)
        fc8d_noise = out['fc8d'] + fc(fc7_noisy, self.noisy_fc8d,
                                      torch.float32)
        out['rois_pred_noise'] = _two_stream(fc8c_noise, fc8d_noise,
                                             valid_mask)
        return out


def add_background_column(rois_pred):
    """Prepend a dummy background column (a copy of the first foreground
    class) so downstream NMS sees num_classes columns."""
    return torch.cat([rois_pred[:, :1], rois_pred], dim=1)
