"""The weakly supervised mask heads (MODEL.MASK_ON; port of the JAX
package's ``models/seg_head.py``).

``MaskFcnHead`` is ``wsl_seg_heads.mask_rcnn_fcn_head``: pooled RoI features
-> ``num_convs`` x (3x3 conv, dilation MRCNN.DILATION, ReLU) -> 2x2 stride-2
deconv, ReLU -> 1x1 conv to num_classes - 1 mask logits. Its weak loss
(``mask_losses``) max-pools each RoI's logits to one logit per class and
applies the weighted sigmoid CE against the image labels, weighted by the
detection scores. The tower runs in float32 whatever the body's dtype.

``DeeplabHead`` is ``wsl_seg_heads.deeplab_vgg16_head``: an image-level
ASPP head over conv5 (four branches with holes 6, 12, 18, 24, their logits
summed), trained by a seed loss against CPG pseudo labels and a
consistency loss against the dense CRF's refinement (``deeplab_losses``).
It computes in the body's dtype and returns float32 logits.

Maps are channels-last at the public functions, as in the JAX package.
Not ported: the ``v0up`` / ``v0upshare`` (ResNet res5) and GroupNorm
variants of the fcn head.
"""

import torch
import torch.nn.functional as F
from torch import nn

from nafwebsod_torch.models.heads import dropout
from nafwebsod_torch.ops import misc as misc_ops
from nafwebsod_torch.ops import seg as seg_ops

ASPP_HOLES = (6, 12, 18, 24)


class Deconv2x2(nn.Module):
    """The 2x2 stride-2 upsampling deconvolution. Its weight is kept as the
    checkpoint holds it, (out, in, 2, 2). The JAX package applies it with
    ``lax.conv_transpose``, which does not flip the kernel: output cell
    (2a + dy, 2b + dx) takes the tap (1 - dy, 1 - dx), where a true
    transposed convolution (``F.conv_transpose2d``) takes (dy, dx). So the
    two spatial axes are reversed here, besides the swap of the channel
    axes to ``conv_transpose2d``'s (in, out, kh, kw)."""

    def __init__(self, dim_in, dim_out, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((dim_out, dim_in, 2, 2),
                                               device=device))
        self.bias = nn.Parameter(torch.empty((dim_out,), device=device))

    def forward(self, x):
        return F.conv_transpose2d(
            x, self.weight.permute(1, 0, 2, 3).flip(2, 3), self.bias,
            stride=2)


@torch.no_grad()
def _normal_init(module, std, generator):
    """Normal(0, std) weights and zero biases, as the JAX package
    initialises both mask heads."""
    for name, p in module.named_parameters():
        if name.endswith('bias'):
            p.zero_()
        else:
            p.normal_(0.0, std, generator=generator)


class MaskFcnHead(nn.Module):
    """The fcn mask tower over pooled RoI features."""

    def __init__(self, num_classes, dim_in=512, dim_inner=256, num_convs=2,
                 dilation=2, device=None):
        super().__init__()
        self.num_convs = num_convs
        d = dim_in
        for i in range(num_convs):
            setattr(self, 'fcn{}'.format(i + 1), nn.Conv2d(
                d, dim_inner, 3, padding=dilation, dilation=dilation,
                device=device))
            d = dim_inner
        self.conv5_mask = Deconv2x2(dim_inner, dim_inner, device)
        self.mask_fcn_logits = nn.Conv2d(dim_inner, num_classes - 1, 1,
                                         device=device)

    def reset_parameters(self, generator):
        _normal_init(self, 0.001, generator)

    def forward(self, pooled):
        """pooled: (R, res, res, C) -> mask logits (R, 2 res, 2 res,
        num_classes - 1), float32."""
        # the channels-last map is the NCHW view's channels_last layout
        x = pooled.float().permute(0, 3, 1, 2)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, 'fcn{}'.format(i + 1))(x))
        x = F.relu(self.conv5_mask(x))
        return self.mask_fcn_logits(x).permute(0, 2, 3, 1)


def mask_losses(mask_logits, rois_pred, rois, labels_oh, valid_mask=None):
    """Max-pool each RoI's mask logits over space to per-RoI class logits,
    weighted sigmoid CE against the broadcast image labels, averaged over
    the valid RoIs."""
    mask_w, _, mask_labels = seg_ops.mask_utility(rois_pred, rois, labels_oh)
    cls_logits = mask_logits.amax(dim=(1, 2))                    # (R, C-1)
    xent = seg_ops.weighted_sigmoid_cross_entropy_with_logits(
        cls_logits, mask_labels, mask_w)
    if valid_mask is not None:
        valid = valid_mask.to(xent.dtype)
        return (xent * valid).sum() / valid.sum().clamp(min=1.0)
    return xent.mean()


def mask_probs_test(mask_logits):
    """Test time: the first class's channel stands in for the background,
    then the sigmoid. (R, M, M, C-1) -> (R, M, M, C)."""
    return torch.sigmoid(torch.cat([mask_logits[..., :1], mask_logits],
                                   dim=-1))


class DeeplabHead(nn.Module):
    """The ASPP head: per hole fc6_k (3x3 dilated) -> fc7_k (1x1) ->
    mask_fc8_k (1x1 to num_classes - 1), each hidden layer with ReLU and
    dropout 0.5; the four branches' logits are summed."""

    def __init__(self, num_classes, dim_in=512, hidden=1024, device=None):
        super().__init__()
        for k, hole in enumerate(ASPP_HOLES, 1):
            setattr(self, 'fc6_{}'.format(k), nn.Conv2d(
                dim_in, hidden, 3, padding=hole, dilation=hole,
                device=device))
            setattr(self, 'fc7_{}'.format(k), nn.Conv2d(
                hidden, hidden, 1, device=device))
            setattr(self, 'mask_fc8_{}'.format(k), nn.Conv2d(
                hidden, num_classes - 1, 1, device=device))

    def reset_parameters(self, generator):
        _normal_init(self, 0.01, generator)

    def forward(self, feat, freeze_body=True, train=False, generator=None):
        """feat: (1, H, W, 512) conv5 features. Returns the summed mask
        logits (1, H, W, num_classes - 1) in float32. The convolutions run
        in ``feat``'s dtype on float32 master weights cast at each use. The
        dropout masks are drawn branch by branch, fc6 before fc7."""
        dt = feat.dtype

        def conv(x, layer):
            return F.conv2d(x, layer.weight.to(dt), layer.bias.to(dt),
                            padding=layer.padding, dilation=layer.dilation)

        # pool5: 3x3 stride-1 max pool, padded with -inf
        x = F.max_pool2d(feat.permute(0, 3, 1, 2), 3, stride=1, padding=1)
        if freeze_body:
            x = x.detach()
        out = None
        for k in range(1, len(ASPP_HOLES) + 1):
            h = F.relu(conv(x, getattr(self, 'fc6_{}'.format(k))))
            h = dropout(h, 0.5, generator, train)
            h = F.relu(conv(h, getattr(self, 'fc7_{}'.format(k))))
            h = dropout(h, 0.5, generator, train)
            logit = conv(h, getattr(self, 'mask_fc8_{}'.format(k)))
            out = logit if out is None else out + logit
        return out.float().permute(0, 2, 3, 1)


def deeplab_outputs(mask_fc8):
    """The sigmoid path: per-class sigmoid; background = 1 - max; the
    background and foreground channels softmaxed together -> (1, H, W, C)
    probabilities; unary = -log(probabilities). Returns (sigmoid, probs,
    unary)."""
    sig = torch.sigmoid(mask_fc8)
    bg = 1.0 - sig.amax(dim=-1, keepdim=True)
    probs = torch.softmax(torch.cat([bg, sig], dim=-1), dim=-1)
    return sig, probs, -torch.log(probs.clamp(min=1e-20))


def bgfg_grid(mask_fc8):
    """Test time: (1, h, w, C) grid of [1 - max_c sigmoid, sigmoid]."""
    sig = torch.sigmoid(mask_fc8)
    return torch.cat([1.0 - sig.amax(dim=-1, keepdim=True), sig], dim=-1)


def deeplab_losses(mask_fc8, cpg, labels_oh, cls_prob, image, tau=0.7,
                   run_crf=True):
    """The deeplab head's two losses. ``mask_seed_loss``: the WSL sigmoid
    CE of the logits, upsampled to the image, against the pseudo targets of
    the CPG maps ``cpg`` (1, C-1, H_im, W_im). ``mask_constraint_loss``:
    the balanced KL between the sigmoid probabilities and the foreground
    probabilities of the dense CRF, which runs on the mask grid with the
    image resized down to it (antialiased, as ``jax.image.resize`` does
    when it shrinks); the CRF's output is a constant for the gradient.
    mask_fc8: (1, h, w, C-1); image: (1, H, W, 3). The CPGSW switch
    (WSL.CPG_MAX_ITER > 0) is not ported."""
    h_im, w_im = cpg.shape[2], cpg.shape[3]
    targets = seg_ops.deeplab_utility_sigmoid(cpg, labels_oh, cls_prob,
                                              tau=tau)
    logits_up = seg_ops.upsample_bilinear_wsl(
        mask_fc8.permute(0, 3, 1, 2), h_im, w_im)            # (1,C-1,H,W)
    xent, _ = misc_ops.sigmoid_cross_entropy_with_logits_wsl(logits_up,
                                                             targets)
    losses = {'mask_seed_loss': xent.sum(dim=1).mean()}
    if run_crf:
        sig, _, unary = deeplab_outputs(mask_fc8)
        im_small = F.interpolate(
            image.float().permute(0, 3, 1, 2), size=mask_fc8.shape[1:3],
            mode='bilinear', align_corners=False, antialias=True)
        q = seg_ops.dense_crf(unary[0].detach().permute(2, 0, 1),
                              im_small[0].permute(1, 2, 0))
        crf_fg = q[1:].permute(1, 2, 0)[None]                # (1,h,w,C-1)
        losses['mask_constraint_loss'] = misc_ops.kl_balanced(
            sig, crf_fg.detach()).mean()
    return losses
