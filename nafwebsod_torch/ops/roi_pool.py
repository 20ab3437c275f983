"""RoIPoolF and RoIFeatureBoost (port of the JAX package's
``ops/roi_pool.py``).

Layout as in the JAX package: ``feat`` is one image's (H, W, C) map,
channels last; ``rois`` are (R, 5) float32 rows of (batch, x1, y1, x2, y2)
in image coordinates; the pooled output is (R, PH, PW, C) in the feature
dtype.

``roi_pool`` launches the hand-written CUDA kernel (``csrc/roi_pool.cu``,
the port of the TPU kernel ``roi_pool_pallas``) for a CUDA tensor and uses
the plain version ``roi_pool_reference`` for a CPU tensor. When the map
needs a gradient it goes through the ``RoIPoolF`` autograd function, whose
backward launches ``csrc/roi_pool_bwd.cu`` (the port of
``roi_pool_pallas_bwd``) for a CUDA tensor and uses
``roi_pool_backward_reference`` for a CPU tensor. There is no fallback: a
CUDA tensor a kernel does not take raises.
"""

import ctypes
import math

import torch

from nafwebsod_torch.ops import _build


def _round_half_away(x):
    """C-style round(): half away from zero (``torch.round`` rounds half to
    even)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def roi_pool(feat, rois, pooled_h=7, pooled_w=7, spatial_scale=0.125):
    """Exact RoIPoolF max pooling. Returns (R, pooled_h, pooled_w, C).
    Differentiable in ``feat`` (the cotangent of a bin goes to its first
    max cell); there is no second derivative."""
    if feat.requires_grad and torch.is_grad_enabled():
        return RoIPoolF.apply(feat, rois, pooled_h, pooled_w, spatial_scale)
    return _roi_pool_forward(feat, rois, pooled_h, pooled_w, spatial_scale)


def _roi_pool_forward(feat, rois, pooled_h, pooled_w, spatial_scale):
    if feat.is_cuda:
        return roi_pool_cuda(feat, rois, pooled_h, pooled_w, spatial_scale)
    if feat.device.type != 'cpu':
        raise ValueError('roi_pool: unsupported device {}'.format(
            feat.device))
    return roi_pool_reference(feat, rois, pooled_h, pooled_w, spatial_scale)


def _bin_edges(lo, extent, pooled, size):
    """[start, end) cells of each of ``pooled`` bins of a RoI that starts
    at ``lo`` and spans ``extent`` cells, clipped to [0, size]:
    floor(p * extent / pooled) and ceil((p + 1) * extent / pooled) in exact
    integer arithmetic. lo, extent: (R,) int64 -> two (R, pooled)."""
    p = torch.arange(pooled, device=lo.device)
    start = (p[None] * extent[:, None]) // pooled + lo[:, None]
    end = ((p[None] + 1) * extent[:, None] + pooled - 1) // pooled \
        + lo[:, None]
    return start.clamp(0, size), end.clamp(0, size)


def _bin_max(feat, hs, he, ws, we, inner=None, chunk=16):
    """The max of every bin, -inf for an empty one: a masked row max over
    each bin's rows, then a masked column max, over chunks of ``chunk``
    RoIs. hs, he: (R, PH) row edges; ws, we: (R, PW) column edges; returns
    (R, PH, PW, C). With ``inner`` = (ix1, iy1, ix2, iy2), each (R,), the
    cells with iy1 < y < iy2 and ix1 < x < ix2 are left out (RoILoopPool's
    ring). The gather windows are as tall and wide as this call's largest
    bin."""
    h, w, _ = feat.shape
    mbh = max(int((he - hs).max()), 1)
    mbw = max(int((we - ws).max()), 1)
    dy = torch.arange(mbh, device=feat.device)
    dx = torch.arange(mbw, device=feat.device)
    xcoord = torch.arange(w, device=feat.device)
    neg = torch.tensor(-math.inf, dtype=feat.dtype, device=feat.device)
    outs = []
    for i in range(0, hs.shape[0], chunk):
        sl = slice(i, i + chunk)
        ys = hs[sl, :, None] + dy                                 # (r,PH,MBH)
        rows = feat[ys.clamp(0, h - 1)]                   # (r,PH,MBH,W,C)
        keep = (ys < he[sl, :, None])[..., None]            # (r,PH,MBH,1)
        if inner is not None:
            ix1, iy1, ix2, iy2 = (v[sl, None, None] for v in inner)
            inside = (((ys > iy1) & (ys < iy2))[..., None] &
                      ((xcoord > ix1) & (xcoord < ix2))[:, :, None, :])
            keep = keep & ~inside                           # (r,PH,MBH,W)
        rowmax = torch.where(keep[..., None], rows, neg).amax(dim=2)
        xs = ws[sl, :, None] + dx                                 # (r,PW,MBW)
        ridx = torch.arange(xs.shape[0], device=feat.device)[:, None, None]
        cols = rowmax[ridx, :, xs.clamp(0, w - 1)]        # (r,PW,MBW,PH,C)
        cols = torch.where((xs < we[sl, :, None])[..., None, None],
                           cols, neg)
        outs.append(cols.amax(dim=2).permute(0, 2, 1, 3))     # (r,PH,PW,C)
    return torch.cat(outs)


def roi_pool_reference(feat, rois, pooled_h=7, pooled_w=7,
                       spatial_scale=0.125, chunk=16):
    """Plain-PyTorch RoIPoolF (mirrors the JAX ``roi_pool_xla``). Empty bins
    (and any non-finite max) give 0.

    ``roi_pool_xla`` caps its gather windows at ceil(H / PH) + 2 rows
    (likewise for columns), which holds for RoIs clipped to the image; past
    that the two differ and this version (like the CUDA kernel) keeps the
    exact definition."""
    h, w, c = feat.shape
    if rois.shape[0] == 0:
        return feat.new_zeros((0, pooled_h, pooled_w, c))
    q = _round_half_away(rois[:, 1:5].float() * spatial_scale).long()
    x1, y1, x2, y2 = q.unbind(1)
    hs, he = _bin_edges(y1, (y2 - y1 + 1).clamp(min=1), pooled_h, h)
    ws, we = _bin_edges(x1, (x2 - x1 + 1).clamp(min=1), pooled_w, w)
    out = _bin_max(feat, hs, he, ws, we, chunk=chunk)
    return torch.where(torch.isfinite(out), out, out.new_zeros(()))


_SUFFIX = {torch.float32: 'f32', torch.bfloat16: 'bf16'}
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 +
             [ctypes.c_float, ctypes.c_void_p])


def launch_pool_forward(name, feat, rois, roi_cols, pooled_h, pooled_w,
                        spatial_scale):
    """Check the arguments and launch the forward kernel of
    ``csrc/<name>.cu`` (``<name>_fwd_f32`` / ``<name>_fwd_bf16``) on the
    current stream. feat: (H, W, C) contiguous float32 or bfloat16 CUDA
    tensor; rois: (R, roi_cols) contiguous float32 on the same device.
    Returns (out (R, pooled_h, pooled_w, C) in feat's type, whether a
    kernel was launched: not for an empty output)."""
    if not feat.is_cuda:
        raise ValueError('{}_cuda needs a CUDA tensor'.format(name))
    if feat.dtype not in _SUFFIX:
        raise ValueError('{}_cuda: feature dtype {} is not float32 or '
                         'bfloat16'.format(name, feat.dtype))
    if feat.dim() != 3 or not feat.is_contiguous():
        raise ValueError('{}_cuda: feat must be a contiguous (H, W, C) '
                         'map, got shape {} strides {}'.format(
                             name, tuple(feat.shape), feat.stride()))
    if (rois.device != feat.device or rois.dtype != torch.float32
            or rois.dim() != 2 or rois.shape[1] != roi_cols
            or not rois.is_contiguous()):
        raise ValueError('{}_cuda: rois must be a contiguous (R, {}) '
                         'float32 tensor on {}'.format(name, roi_cols,
                                                       feat.device))
    h, w, c = feat.shape
    r = rois.shape[0]
    out = torch.empty((r, pooled_h, pooled_w, c), dtype=feat.dtype,
                      device=feat.device)
    if r == 0 or c == 0:
        return out, False
    lib = _build.load(name)
    fn = getattr(lib, '{}_fwd_{}'.format(name, _SUFFIX[feat.dtype]))
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err_str = getattr(lib, name + '_error_string')
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    rc = fn(feat.data_ptr(), rois.data_ptr(), out.data_ptr(), h, w, c, r,
            pooled_h, pooled_w, spatial_scale, stream)
    if rc != 0:
        raise RuntimeError('{} CUDA launch failed: {}'.format(
            name, err_str(rc).decode()))
    return out, True


def roi_pool_cuda(feat, rois, pooled_h=7, pooled_w=7, spatial_scale=0.125):
    """Launch the CUDA RoIPoolF kernel on the current stream.

    feat: (H, W, C) contiguous float32 or bfloat16 CUDA tensor; rois: (R, 5)
    contiguous float32 on the same device. ``roi_pool_cuda.launches``
    counts the kernel launches."""
    out, launched = launch_pool_forward('roi_pool', feat, rois, 5, pooled_h,
                                        pooled_w, spatial_scale)
    roi_pool_cuda.launches += launched
    return out


roi_pool_cuda.launches = 0


def roi_pool_backward(feat, rois, g, pooled_h=7, pooled_w=7,
                      spatial_scale=0.125):
    """RoIPoolF gradient for G seed batches: g (G, R, PH, PW, C) ->
    dfeat (G, H, W, C) float32. The kernel for a CUDA map, the plain
    version for a CPU map."""
    if feat.is_cuda:
        return roi_pool_backward_cuda(feat, rois, g, pooled_h, pooled_w,
                                      spatial_scale)
    if feat.device.type != 'cpu':
        raise ValueError('roi_pool_backward: unsupported device {}'.format(
            feat.device))
    return roi_pool_backward_reference(feat, rois, g, pooled_h, pooled_w,
                                       spatial_scale)


class RoIPoolF(torch.autograd.Function):
    """RoIPoolF with its argmax-scatter gradient. Saves (feat, rois) and
    recomputes each bin's first max in the backward, as the JAX package's
    ``custom_vjp`` does."""

    @staticmethod
    def forward(ctx, feat, rois, pooled_h, pooled_w, spatial_scale):
        ctx.save_for_backward(feat, rois)
        ctx.pool_args = (pooled_h, pooled_w, spatial_scale)
        return _roi_pool_forward(feat, rois, pooled_h, pooled_w,
                                 spatial_scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        feat, rois = ctx.saved_tensors
        dfeat = roi_pool_backward(feat, rois, g[None].contiguous(),
                                  *ctx.pool_args)[0]
        return dfeat.to(feat.dtype), None, None, None, None


def roi_pool_backward_reference(feat, rois, g, pooled_h=7, pooled_w=7,
                                spatial_scale=0.125, max_elements=1 << 25):
    """Plain-PyTorch RoIPoolF gradient: per bin the first max cell in
    row-major order (the least linear index among the cells equal to the
    max -- ``torch.argmax`` does not promise the first index on every
    backend), then ``index_add_`` of the cotangents into float32. An empty
    bin and a bin whose max is not finite pass nothing back. Works on
    chunks of RoIs whose gathered windows hold at most ``max_elements``
    values."""
    h, w, c = feat.shape
    n_seeds, r = g.shape[:2]
    dfeat = torch.zeros((n_seeds, h * w * c), dtype=torch.float32,
                        device=feat.device)
    if r == 0 or c == 0:
        return dfeat.view(n_seeds, h, w, c)
    q = _round_half_away(rois[:, 1:5].float() * spatial_scale).long()
    x1, y1, x2, y2 = q.unbind(1)
    hs, he = _bin_edges(y1, (y2 - y1 + 1).clamp(min=1), pooled_h, h)
    ws, we = _bin_edges(x1, (x2 - x1 + 1).clamp(min=1), pooled_w, w)
    mbh = max(int((he - hs).max()), 1)
    mbw = max(int((we - ws).max()), 1)
    dy = torch.arange(mbh, device=feat.device)
    dx = torch.arange(mbw, device=feat.device)
    k = mbh * mbw
    order = torch.arange(k, device=feat.device)[:, None]
    chan = torch.arange(c, device=feat.device)
    chunk = max(1, max_elements // (pooled_h * pooled_w * k * c))
    featf = feat.float()
    gf = g.float()
    for i in range(0, r, chunk):
        sl = slice(i, i + chunk)
        ys = (hs[sl, :, None] + dy)[:, :, None, :, None]    # (r,PH,1,MBH,1)
        xs = (ws[sl, :, None] + dx)[:, None, :, None, :]    # (r,1,PW,1,MBW)
        inside = ((ys < he[sl, :, None, None, None]) &
                  (xs < we[sl, None, :, None, None]))   # (r,PH,PW,MBH,MBW)
        cell = (ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1)).reshape(
            -1, pooled_h, pooled_w, k)
        inside = inside.reshape(-1, pooled_h, pooled_w, k)
        vals = featf.view(h * w, c)[cell]                  # (r,PH,PW,K,C)
        vals = torch.where(inside[..., None], vals,
                           vals.new_full((), -math.inf))
        m = vals.amax(dim=3)                                 # (r,PH,PW,C)
        first = torch.where((vals == m[:, :, :, None]) & inside[..., None],
                            order, k).amin(dim=3)            # (r,PH,PW,C)
        ok = torch.isfinite(m) & (first < k)
        best = cell.gather(3, first.clamp(max=k - 1))       # (r,PH,PW,C)
        index = (best * c + chan).reshape(-1)
        src = torch.where(ok, gf[:, sl], gf.new_zeros(())).reshape(
            n_seeds, -1)
        dfeat.index_add_(1, index, src)
    return dfeat.view(n_seeds, h, w, c)


_BWD_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 +
                 [ctypes.c_float, ctypes.c_void_p])


def _bwd_kernel_fn(feat_dtype, g_dtype):
    lib = _build.load('roi_pool_bwd')
    fn = getattr(lib, 'roi_pool_bwd_{}_{}'.format(_SUFFIX[feat_dtype],
                                                  _SUFFIX[g_dtype]))
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    lib.roi_pool_bwd_error_string.argtypes = [ctypes.c_int]
    lib.roi_pool_bwd_error_string.restype = ctypes.c_char_p
    return fn, lib.roi_pool_bwd_error_string


def roi_pool_backward_cuda(feat, rois, g, pooled_h=7, pooled_w=7,
                           spatial_scale=0.125):
    """Launch the CUDA RoIPoolF backward kernel on the current stream.

    feat: (H, W, C) contiguous float32 or bfloat16 CUDA tensor; rois:
    (R, 5) contiguous float32; g: (G, R, pooled_h, pooled_w, C) contiguous
    float32 or bfloat16, all on one device. Returns dfeat (G, H, W, C)
    float32. The sums are float atomics: their last bits depend on the
    order the card adds in. ``roi_pool_backward_cuda.launches`` counts the
    kernel launches."""
    if not feat.is_cuda:
        raise ValueError('roi_pool_backward_cuda needs a CUDA tensor')
    if feat.dtype not in _SUFFIX or g.dtype not in _SUFFIX:
        raise ValueError('roi_pool_backward_cuda: feature dtype {} and '
                         'cotangent dtype {} must be float32 or bfloat16'
                         .format(feat.dtype, g.dtype))
    if feat.dim() != 3 or not feat.is_contiguous():
        raise ValueError('roi_pool_backward_cuda: feat must be a contiguous '
                         '(H, W, C) map, got shape {} strides {}'.format(
                             tuple(feat.shape), feat.stride()))
    if (rois.device != feat.device or rois.dtype != torch.float32
            or rois.dim() != 2 or rois.shape[1] != 5
            or not rois.is_contiguous()):
        raise ValueError('roi_pool_backward_cuda: rois must be a contiguous '
                         '(R, 5) float32 tensor on {}'.format(feat.device))
    h, w, c = feat.shape
    r = rois.shape[0]
    if (g.device != feat.device or g.dim() != 5
            or tuple(g.shape[1:]) != (r, pooled_h, pooled_w, c)
            or not g.is_contiguous()):
        raise ValueError('roi_pool_backward_cuda: g must be a contiguous '
                         '(G, {}, {}, {}, {}) tensor on {}, got {}'.format(
                             r, pooled_h, pooled_w, c, feat.device,
                             tuple(g.shape)))
    n_seeds = g.shape[0]
    dfeat = torch.zeros((n_seeds, h, w, c), dtype=torch.float32,
                        device=feat.device)
    if r == 0 or c == 0 or n_seeds == 0:
        return dfeat
    fn, err_str = _bwd_kernel_fn(feat.dtype, g.dtype)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    rc = fn(feat.data_ptr(), rois.data_ptr(), g.data_ptr(), dfeat.data_ptr(),
            h, w, c, r, n_seeds, pooled_h, pooled_w, spatial_scale, stream)
    if rc != 0:
        raise RuntimeError('roi_pool backward CUDA launch failed: {}'.format(
            err_str(rc).decode()))
    roi_pool_backward_cuda.launches += 1
    return dfeat


roi_pool_backward_cuda.launches = 0


def roi_feature_boost(roi_feat, obn_scores):
    """Scale each RoI's features by its objectness score, with no gradient
    to the score. roi_feat: (R, ...); obn_scores: (R,) or (R, 1)."""
    s = obn_scores.reshape(obn_scores.shape[0], -1)[:, 0].detach()
    s = s.to(roi_feat.dtype)  # bf16 activations stay bf16
    return roi_feat * s.reshape((-1,) + (1,) * (roi_feat.dim() - 1))
