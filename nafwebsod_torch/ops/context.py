"""Context-aware RoI ops: frame / context ring RoIs and ring max pooling
(port of the JAX package's ``ops/context.py``).

``roi_context`` turns each 5-column RoI into two 9-column RoIs (batch,
outer box, inner box): the frame RoI keeps the proposal as its outer box
and shrinks it by ``context_ratio`` for the inner one; the context RoI
grows the proposal by ``context_ratio`` for its outer box and keeps the
proposal as the inner one.

``roi_loop_pool`` is RoILoopPool: RoIPoolF's max over the outer box's bins,
leaving out the cells strictly inside the inner box, with the running max
started at 0. It launches the hand-written CUDA kernel
(``csrc/roi_loop_pool.cu``, the port of the TPU kernel
``roi_loop_pool_pallas``) for a CUDA map and uses the plain version
``roi_loop_pool_reference`` for a CPU map. There is no fallback: a CUDA
tensor the kernel does not take raises.
"""

import torch

from nafwebsod_torch.ops import roi_pool as rp


def roi_context(rois, im_h, im_w, context_ratio=1.8):
    """(R, 5) rois -> (frame rois (R, 9), context rois (R, 9)), float32.

    The shrunk and the grown coordinates are clipped to [0, im_w] and
    [0, im_h]; the frame's outer box and the context's inner box are the
    proposal itself, unclipped. ``im_h`` and ``im_w`` are Python numbers or
    0-d tensors: the true extent of the image inside a padded canvas."""
    rois = rois.float()
    b, x1, y1, x2, y2 = rois.unbind(1)
    w = x2 - x1
    h = y2 - y1
    inner_res_w = (w - w / context_ratio) / 2.0
    inner_res_h = (h - h / context_ratio) / 2.0
    outer_res_w = (w * context_ratio - w) / 2.0
    outer_res_h = (h * context_ratio - h) / 2.0
    zero = rois.new_zeros(())
    max_x = torch.as_tensor(im_w, dtype=torch.float32, device=rois.device)
    max_y = torch.as_tensor(im_h, dtype=torch.float32, device=rois.device)

    def clipx(v):
        return torch.clamp(v, zero, max_x)

    def clipy(v):
        return torch.clamp(v, zero, max_y)

    frame = torch.stack([
        b, x1, y1, x2, y2,
        clipx(x1 + inner_res_w), clipy(y1 + inner_res_h),
        clipx(x2 - inner_res_w), clipy(y2 - inner_res_h)], dim=1)
    context = torch.stack([
        b,
        clipx(x1 - outer_res_w), clipy(y1 - outer_res_h),
        clipx(x2 + outer_res_w), clipy(y2 + outer_res_h),
        x1, y1, x2, y2], dim=1)
    return frame, context


def roi_loop_pool(feat, rois9, pooled_h=7, pooled_w=7, spatial_scale=0.125):
    """Ring max pooling over 9-column RoIs. feat: (H, W, C); returns
    (R, pooled_h, pooled_w, C) in the feature dtype. Forward only: the
    context head pools from a frozen body."""
    if feat.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            'roi_loop_pool has no gradient yet: the context head with an '
            'unfrozen body (TRAIN.FREEZE_CONV_BODY False) is queued in '
            'ROADMAP.md (queue 2, "K2 backward: the ring pool\'s gradient '
            'for unfrozen bodies")')
    if feat.is_cuda:
        return roi_loop_pool_cuda(feat, rois9, pooled_h, pooled_w,
                                  spatial_scale)
    if feat.device.type != 'cpu':
        raise ValueError('roi_loop_pool: unsupported device {}'.format(
            feat.device))
    return roi_loop_pool_reference(feat, rois9, pooled_h, pooled_w,
                                   spatial_scale)


def roi_loop_pool_reference(feat, rois9, pooled_h=7, pooled_w=7,
                            spatial_scale=0.125, chunk=16):
    """Plain-PyTorch RoILoopPool (the function of the JAX
    ``roi_loop_pool_xla``): per bin of the outer box the max over the cells
    that are not strictly inside the inner box, floored at 0; an empty
    ring, an all-negative ring and a ring whose max is not finite (a NaN or
    an infinity among its cells) give 0.

    ``roi_loop_pool_xla`` caps its gather windows at ceil(H / PH) + 2 rows
    (likewise for columns), which holds for outer boxes clipped to the
    image; this version (like the CUDA kernel) keeps the exact definition
    at any size."""
    h, w, c = feat.shape
    if rois9.shape[0] == 0:
        return feat.new_zeros((0, pooled_h, pooled_w, c))
    q = rp._round_half_away(rois9[:, 1:9].float() * spatial_scale).long()
    x1, y1, x2, y2, ix1, iy1, ix2, iy2 = q.unbind(1)
    hs, he = rp._bin_edges(y1, (y2 - y1 + 1).clamp(min=1), pooled_h, h)
    ws, we = rp._bin_edges(x1, (x2 - x1 + 1).clamp(min=1), pooled_w, w)
    out = rp._bin_max(feat, hs, he, ws, we, inner=(ix1, iy1, ix2, iy2),
                      chunk=chunk)
    zero = out.new_zeros(())
    return torch.maximum(torch.where(torch.isfinite(out), out, zero), zero)


def roi_loop_pool_cuda(feat, rois9, pooled_h=7, pooled_w=7,
                       spatial_scale=0.125):
    """Launch the CUDA RoILoopPool kernel on the current stream.

    feat: (H, W, C) contiguous float32 or bfloat16 CUDA tensor, any C and
    any base address (``rp.channels_per_load`` says which loads the kernel
    uses); rois9: (R, 9) contiguous float32 on the same device.
    ``roi_loop_pool_cuda.launches`` counts the kernel launches."""
    out, launched = rp.launch_pool_forward(
        'roi_loop_pool', feat, rois9, 9, pooled_h, pooled_w, spatial_scale)
    roi_loop_pool_cuda.launches += launched
    return out


roi_loop_pool_cuda.launches = 0
