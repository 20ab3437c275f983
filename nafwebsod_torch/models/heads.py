"""WSDDN / noise-aware webly heads (port of the JAX package's
``models/heads.py``: the 2fc tower with and without the noisy twin, the
three-stream context head, the two-stream outputs and the image-level
score).

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

from nafwebsod_torch.ops import context as context_ops
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


def dropout(x, rate, generator, train):
    """``where(mask, x / keep, 0)`` with the mask drawn from ``generator``
    (a ``torch.Generator`` on ``x``'s device). No dropout when ``train`` is
    false or ``generator`` is None: a training forward without a generator
    is deterministic, which the parity tests rely on."""
    if not train or rate <= 0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class FcTower(nn.Module):
    """fc6 -> relu -> dropout -> fc7 -> relu -> dropout (dropout 0.5 only
    when ``train`` and a generator is given)."""

    def __init__(self, dim_in, hidden, device=None):
        super().__init__()
        self.fc6 = nn.Linear(dim_in, hidden, device=device)
        self.fc7 = nn.Linear(hidden, hidden, device=device)

    def forward(self, x, train=False, generator=None):
        x = dropout(F.relu(fc(x, self.fc6)), 0.5, generator, train)
        return dropout(F.relu(fc(x, self.fc7)), 0.5, generator, train)


def roi_transform(feat, rois, obn_scores, spatial_scale, resolution=7,
                  freeze_body=True, method='RoIPoolF', sampling_ratio=2):
    """RoIPoolF or RoIAlign, then RoIFeatureBoost (+ no gradient into a
    frozen body), flattened in C*H*W order like the reference's NCHW blobs,
    so reference fc6 weights apply without a transpose. feat: (H, W, C)."""
    if method == 'RoIAlign':
        pooled = roi_ops.roi_align(feat, rois, resolution, resolution,
                                   spatial_scale, sampling_ratio)
    else:
        pooled = roi_ops.roi_pool(feat, rois, resolution, resolution,
                                  spatial_scale)
    pooled = roi_ops.roi_feature_boost(pooled, obn_scores)
    if freeze_body:
        pooled = pooled.detach()
    return pooled.permute(0, 3, 1, 2).reshape(pooled.shape[0], -1)


def context_pooled_feats(feat, rois, obn_scores, spatial_scale, im_h, im_w,
                         context_ratio=1.8, resolution=7, freeze_body=True):
    """The three flattened RoI feature streams of the context head: the
    proposal through RoIPoolF, its frame and its context ring through
    RoILoopPool, each boosted by the objectness and flattened in C*H*W
    order. feat: (H, W, C); ``im_h``, ``im_w``: the extent the rings are
    clipped to."""
    frame, context = context_ops.roi_context(rois, im_h, im_w, context_ratio)
    pooled = (
        roi_ops.roi_pool(feat, rois, resolution, resolution, spatial_scale),
        context_ops.roi_loop_pool(feat, frame, resolution, resolution,
                                  spatial_scale),
        context_ops.roi_loop_pool(feat, context, resolution, resolution,
                                  spatial_scale))
    outs = []
    for x in pooled:
        x = roi_ops.roi_feature_boost(x, obn_scores)
        if freeze_body:
            x = x.detach()
        outs.append(x.permute(0, 3, 1, 2).reshape(x.shape[0], -1))
    return tuple(outs)


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


class WslHead(nn.Module):
    """The 2fc head and its outputs: a clean fc6/fc7 tower over the boosted
    RoI features and the WSDDN fc8c/fc8d two-stream layers on it
    (``wsl_heads.add_VGG16_roi_2fc_head`` + ``wsl_outputs``). With
    ``noisy`` it is the noise-aware head: a second, noisy tower over the
    same features and the noisy residual logits
    (``webly_heads.add_VGG16_roi_2fc_noise_head`` + ``webly_outputs``).
    With ``context`` it is the context head
    (``wsl_heads.add_VGG16_roi_context_2fc_head`` +
    ``add_wsl_context_outputs``): the one tower runs over three feature
    streams, and the detection stream's layer is ``fc8d_frame`` (there is
    no ``fc8d``)."""

    def __init__(self, num_classes, roi_feat_dim=512 * 7 * 7, hidden=4096,
                 device=None, noisy=True, context=False):
        super().__init__()
        c = num_classes - 1
        self.clean = FcTower(roi_feat_dim, hidden, device)
        self.fc8c = nn.Linear(hidden, c, device=device)
        if context:
            self.fc8d_frame = nn.Linear(hidden, c, device=device)
        else:
            self.fc8d = nn.Linear(hidden, c, device=device)
        if noisy:
            self.noisy = FcTower(roi_feat_dim, hidden, device)
            self.noisy_fc8c = nn.Linear(hidden, c, device=device)
            self.noisy_fc8d = nn.Linear(hidden, c, device=device)
        else:
            self.noisy = None

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Xavier-uniform weights, zero biases."""
        for layer in self.modules():
            if isinstance(layer, nn.Linear):
                _xavier_(layer.weight, generator)
                layer.bias.zero_()

    def towers(self, roi_feat, train=False, generator=None):
        """(fc7 of the clean tower, fc7 of the noisy tower or None). The
        dropout masks are drawn clean tower first."""
        clean = self.clean(roi_feat, train, generator)
        if self.noisy is None:
            return clean, None
        return clean, self.noisy(roi_feat, train, generator)

    def context_towers(self, flats, train=False, generator=None):
        """fc7 of the plain, the frame and the context stream: the same
        fc6/fc7 weights over each of ``context_pooled_feats``' streams, so
        their gradient sums the three uses. The dropout masks are drawn
        stream by stream, in that order."""
        return tuple(self.clean(x, train, generator) for x in flats)

    def wsl_context_outputs(self, fc7s, valid_mask=None):
        """fc8c on the plain stream; fc8d = FC(frame) - FC(context) through
        the one ``fc8d_frame`` layer (its bias cancels and gets a zero
        gradient)."""
        fc7, fc7_frame, fc7_context = fc7s
        fc8c = fc(fc7, self.fc8c, torch.float32)
        fc8d = (fc(fc7_frame, self.fc8d_frame, torch.float32)
                - fc(fc7_context, self.fc8d_frame, torch.float32))
        return {'fc8c': fc8c, 'fc8d': fc8d,
                'rois_pred': _two_stream(fc8c, fc8d, valid_mask)}

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


def cls_pred(rois_pred):
    """Image-level class score: the sum over RoIs, (1, C)."""
    return rois_pred.sum(dim=0, keepdim=True)


def add_background_column(rois_pred):
    """Prepend a dummy background column (a copy of the first foreground
    class) so downstream NMS sees num_classes columns."""
    return torch.cat([rois_pred[:, :1], rois_pred], dim=1)
