"""RoIPoolF and RoIFeatureBoost (port of the JAX package's
``ops/roi_pool.py``).

Layout as in the JAX package: ``feat`` is one image's (H, W, C) map,
channels last; ``rois`` are (R, 5) float32 rows of (batch, x1, y1, x2, y2)
in image coordinates; the pooled output is (R, PH, PW, C) in the feature
dtype.

``roi_pool`` launches the hand-written CUDA kernel (``csrc/roi_pool.cu``,
the port of the TPU kernel ``roi_pool_pallas``) for a CUDA tensor and uses
the plain version ``roi_pool_reference`` for a CPU tensor. There is no
fallback: a CUDA tensor the kernel does not take raises.
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
    """Exact RoIPoolF max pooling. Returns (R, pooled_h, pooled_w, C)."""
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


def roi_pool_reference(feat, rois, pooled_h=7, pooled_w=7,
                       spatial_scale=0.125, chunk=16):
    """Plain-PyTorch RoIPoolF (mirrors the JAX ``roi_pool_xla``): a masked
    row max over each bin's rows, then a masked column max, over chunks of
    ``chunk`` RoIs. Empty bins (and any non-finite max) give 0.

    The gather windows are as tall and wide as this call's largest bin.
    ``roi_pool_xla`` caps them at ceil(H / PH) + 2 rows (likewise for
    columns), which holds for RoIs clipped to the image; past that the two
    differ and this version (like the CUDA kernel) keeps the exact
    definition."""
    h, w, c = feat.shape
    q = _round_half_away(rois[:, 1:5].float() * spatial_scale).long()
    x1, y1, x2, y2 = q.unbind(1)
    hs, he = _bin_edges(y1, (y2 - y1 + 1).clamp(min=1), pooled_h, h)
    ws, we = _bin_edges(x1, (x2 - x1 + 1).clamp(min=1), pooled_w, w)
    if rois.shape[0] == 0:
        return feat.new_zeros((0, pooled_h, pooled_w, c))
    mbh = max(int((he - hs).max()), 1)
    mbw = max(int((we - ws).max()), 1)
    dy = torch.arange(mbh, device=feat.device)
    dx = torch.arange(mbw, device=feat.device)
    neg = torch.tensor(-math.inf, dtype=feat.dtype, device=feat.device)
    outs = []
    for i in range(0, rois.shape[0], chunk):
        sl = slice(i, i + chunk)
        ys = hs[sl, :, None] + dy                                 # (r,PH,MBH)
        rows = feat[ys.clamp(0, h - 1)]                   # (r,PH,MBH,W,C)
        rows = torch.where((ys < he[sl, :, None])[..., None, None],
                           rows, neg)
        rowmax = rows.amax(dim=2)                             # (r,PH,W,C)
        xs = ws[sl, :, None] + dx                                 # (r,PW,MBW)
        ridx = torch.arange(xs.shape[0], device=feat.device)[:, None, None]
        cols = rowmax[ridx, :, xs.clamp(0, w - 1)]        # (r,PW,MBW,PH,C)
        cols = torch.where((xs < we[sl, :, None])[..., None, None],
                           cols, neg)
        out = cols.amax(dim=2).permute(0, 2, 1, 3)            # (r,PH,PW,C)
        outs.append(torch.where(torch.isfinite(out), out,
                                torch.zeros((), dtype=out.dtype,
                                            device=out.device)))
    return torch.cat(outs)


_KERNELS = {torch.float32: 'roi_pool_fwd_f32',
            torch.bfloat16: 'roi_pool_fwd_bf16'}
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 +
             [ctypes.c_float, ctypes.c_void_p])


def _kernel_fn(dtype):
    lib = _build.load('roi_pool')
    fn = getattr(lib, _KERNELS[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    lib.roi_pool_error_string.argtypes = [ctypes.c_int]
    lib.roi_pool_error_string.restype = ctypes.c_char_p
    return fn, lib.roi_pool_error_string


def roi_pool_cuda(feat, rois, pooled_h=7, pooled_w=7, spatial_scale=0.125):
    """Launch the CUDA RoIPoolF kernel on the current stream.

    feat: (H, W, C) contiguous float32 or bfloat16 CUDA tensor; rois: (R, 5)
    contiguous float32 on the same device. ``roi_pool_cuda.launches``
    counts the kernel launches."""
    if not feat.is_cuda:
        raise ValueError('roi_pool_cuda needs a CUDA tensor')
    if feat.dtype not in _KERNELS:
        raise ValueError('roi_pool_cuda: feature dtype {} is not float32 or '
                         'bfloat16'.format(feat.dtype))
    if feat.dim() != 3 or not feat.is_contiguous():
        raise ValueError('roi_pool_cuda: feat must be a contiguous (H, W, C) '
                         'map, got shape {} strides {}'.format(
                             tuple(feat.shape), feat.stride()))
    if (rois.device != feat.device or rois.dtype != torch.float32
            or rois.dim() != 2 or rois.shape[1] != 5
            or not rois.is_contiguous()):
        raise ValueError('roi_pool_cuda: rois must be a contiguous (R, 5) '
                         'float32 tensor on {}'.format(feat.device))
    h, w, c = feat.shape
    r = rois.shape[0]
    out = torch.empty((r, pooled_h, pooled_w, c), dtype=feat.dtype,
                      device=feat.device)
    if r == 0 or c == 0:
        return out
    fn, err_str = _kernel_fn(feat.dtype)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    rc = fn(feat.data_ptr(), rois.data_ptr(), out.data_ptr(), h, w, c, r,
            pooled_h, pooled_w, spatial_scale, stream)
    if rc != 0:
        raise RuntimeError('roi_pool CUDA launch failed: {}'.format(
            err_str(rc).decode()))
    roi_pool_cuda.launches += 1
    return out


roi_pool_cuda.launches = 0


def roi_feature_boost(roi_feat, obn_scores):
    """Scale each RoI's features by its objectness score, with no gradient
    to the score. roi_feat: (R, ...); obn_scores: (R,) or (R, 1)."""
    s = obn_scores.reshape(obn_scores.shape[0], -1)[:, 0].detach()
    s = s.to(roi_feat.dtype)  # bf16 activations stay bf16
    return roi_feat * s.reshape((-1,) + (1,) * (roi_feat.dim() - 1))
