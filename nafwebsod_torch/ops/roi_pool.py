"""RoIPoolF, RoIAlign and RoIFeatureBoost (port of the JAX package's
``ops/roi_pool.py``).

Layout as in the JAX package: ``feat`` is one image's (H, W, C) map,
channels last; ``rois`` are (R, 5) float32 rows of (batch, x1, y1, x2, y2)
in image coordinates; the pooled output is (R, PH, PW, C) in the feature
dtype.

``roi_pool`` launches the hand-written CUDA kernel (``csrc/roi_pool.cu``,
the port of the TPU kernel ``roi_pool_pallas``) for a CUDA tensor and uses
the plain version ``roi_pool_reference`` for a CPU tensor. When the map
needs a gradient it goes through the ``RoIPoolF`` autograd function: its
forward also writes each output's first max cell (the kernel's index
output, or ``roi_pool_argmax_reference`` on the CPU) and saves it, and its
backward scatters the cotangents to those cells with ``csrc/roi_pool_bwd.cu``
(the port of ``roi_pool_pallas_bwd``) for a CUDA tensor and with
``roi_pool_scatter_reference`` for a CPU tensor. There is no fallback: a
CUDA tensor a kernel does not take raises.

``roi_align`` is Detectron's legacy RoIAlign with a static sampling grid;
its output is float32 or the feature dtype. It launches
``csrc/roi_align.cu`` (the port of ``roi_align_pallas``) for a CUDA tensor
and uses ``roi_align_reference`` for a CPU tensor; forward only (the mask
head and the RoIAlign box transform pool from a frozen body).
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


def _roi_pool_forward(feat, rois, pooled_h, pooled_w, spatial_scale,
                      argmax=False):
    """The pooled map, and with ``argmax`` also its first-max index."""
    if feat.is_cuda:
        return roi_pool_cuda(feat, rois, pooled_h, pooled_w, spatial_scale,
                             argmax=argmax)
    if feat.device.type != 'cpu':
        raise ValueError('roi_pool: unsupported device {}'.format(
            feat.device))
    out = roi_pool_reference(feat, rois, pooled_h, pooled_w, spatial_scale)
    if not argmax:
        return out
    return out, roi_pool_argmax_reference(feat, rois, pooled_h, pooled_w,
                                          spatial_scale)


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


def check_pool_args(name, feat, rois, roi_cols):
    """Raise unless feat is a contiguous (H, W, C) float32 or bfloat16 CUDA
    map and rois a contiguous (R, roi_cols) float32 tensor beside it."""
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


def _kernel_fn(name, symbol, argtypes):
    """(ctypes function ``symbol`` of ``csrc/<name>.cu``, its error-string
    function)."""
    lib = _build.load(name)
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err_str = getattr(lib, name + '_error_string')
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    return fn, err_str


def launch_pool_forward(name, feat, rois, roi_cols, pooled_h, pooled_w,
                        spatial_scale, extra_ints=(), out_dtype=None,
                        extra_outs=()):
    """Check the arguments and launch the forward kernel of
    ``csrc/<name>.cu`` (``<name>_fwd_f32`` / ``<name>_fwd_bf16``) on the
    current stream. feat: (H, W, C) contiguous float32 or bfloat16 CUDA
    tensor, any C and any base address; rois: (R, roi_cols) contiguous
    float32 on the same device; ``extra_outs`` (tensors, or None for a null
    pointer) go to the kernel after ``out``, ``extra_ints`` after
    ``pooled_w`` and before ``channels_per_load(feat)``. Returns (out
    (R, pooled_h, pooled_w, C) in ``out_dtype``, feat's type when None, and
    whether a kernel was launched: not for an empty output)."""
    check_pool_args(name, feat, rois, roi_cols)
    h, w, c = feat.shape
    r = rois.shape[0]
    out = torch.empty((r, pooled_h, pooled_w, c),
                      dtype=out_dtype or feat.dtype, device=feat.device)
    if r == 0 or c == 0:
        return out, False
    fn, err_str = _kernel_fn(
        name, '{}_fwd_{}'.format(name, _SUFFIX[feat.dtype]),
        [ctypes.c_void_p] * (3 + len(extra_outs)) +
        [ctypes.c_int] * (7 + len(extra_ints)) +
        [ctypes.c_float, ctypes.c_void_p])
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    rc = fn(feat.data_ptr(), rois.data_ptr(), out.data_ptr(),
            *(t if t is None else t.data_ptr() for t in extra_outs),
            h, w, c, r, pooled_h, pooled_w, *extra_ints,
            channels_per_load(feat), spatial_scale, stream)
    if rc != 0:
        raise RuntimeError('{} CUDA launch failed: {}'.format(
            name, err_str(rc).decode()))
    return out, True


def channels_per_load(feat):
    """How many channels a thread of the forward kernels (RoIPoolF,
    RoILoopPool, RoIAlign) reads at once: the most of 16 bytes (8 bfloat16
    or 4 float32 channels) that divides a cell's C channels and the map's
    base address, down to one channel. A map whose C or base address does
    not suit 16-byte loads still runs in the kernel, with narrower loads."""
    size = feat.element_size()
    n = 16 // size
    while n > 1 and (feat.shape[-1] % n or feat.data_ptr() % (n * size)):
        n //= 2
    return n


def roi_pool_cuda(feat, rois, pooled_h=7, pooled_w=7, spatial_scale=0.125,
                  argmax=False):
    """Launch the CUDA RoIPoolF kernel on the current stream.

    feat: (H, W, C) contiguous float32 or bfloat16 CUDA tensor, any C and
    any base address (``channels_per_load`` says which loads the kernel
    uses); rois: (R, 5) contiguous float32 on the same device. Returns the
    pooled map, and with ``argmax`` the pair (pooled map, first-max index
    (R, pooled_h, pooled_w, C) int32, flat y * W + x, -1 where no gradient
    flows). ``roi_pool_cuda.launches`` counts the kernel launches,
    ``roi_pool_cuda.argmax_launches`` those that wrote the index."""
    check_pool_args('roi_pool', feat, rois, 5)
    index = (torch.empty((rois.shape[0], pooled_h, pooled_w, feat.shape[2]),
                         dtype=torch.int32, device=feat.device)
             if argmax else None)
    out, launched = launch_pool_forward(
        'roi_pool', feat, rois, 5, pooled_h, pooled_w, spatial_scale,
        extra_outs=(index,))
    roi_pool_cuda.launches += launched
    roi_pool_cuda.argmax_launches += launched and argmax
    return (out, index) if argmax else out


roi_pool_cuda.launches = 0
roi_pool_cuda.argmax_launches = 0


def roi_pool_backward(argmax, g, height, width):
    """RoIPoolF gradient for G seed batches from the forward's first-max
    index: argmax (R, PH, PW, C) int32, g (G, R, PH, PW, C) -> dfeat
    (G, height, width, C) float32. The kernel for a CUDA index, the plain
    version for a CPU one."""
    if argmax.is_cuda:
        return roi_pool_backward_cuda(argmax, g, height, width)
    if argmax.device.type != 'cpu':
        raise ValueError('roi_pool_backward: unsupported device {}'.format(
            argmax.device))
    return roi_pool_scatter_reference(argmax, g, height, width)


class RoIPoolF(torch.autograd.Function):
    """RoIPoolF with its argmax-scatter gradient. The forward writes each
    output's first max cell beside the pooled map and saves that index,
    (R, PH, PW, C) int32 -- 4 bytes per output, held until the graph is
    freed -- instead of the map; every backward (one per CPG seed and one
    for the loss) scatters its cotangents through it."""

    @staticmethod
    def forward(ctx, feat, rois, pooled_h, pooled_w, spatial_scale):
        out, argmax = _roi_pool_forward(feat, rois, pooled_h, pooled_w,
                                        spatial_scale, argmax=True)
        ctx.save_for_backward(argmax)
        ctx.map_shape = (feat.shape[0], feat.shape[1], feat.dtype)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        argmax, = ctx.saved_tensors
        h, w, dtype = ctx.map_shape
        dfeat = roi_pool_backward(argmax, g[None].contiguous(), h, w)[0]
        return dfeat.to(dtype), None, None, None, None


def roi_pool_argmax_reference(feat, rois, pooled_h=7, pooled_w=7,
                              spatial_scale=0.125, max_elements=1 << 25):
    """Plain-PyTorch first-max index of RoIPoolF: per bin and channel the
    first max cell in row-major order (the least linear index among the
    cells equal to the max -- ``torch.argmax`` does not promise the first
    index on every backend) as int32 flat y * W + x, and -1 where no
    gradient flows: an empty bin, a NaN in the bin, an infinite max or a
    bin of -inf cells (the outputs the forward maps to 0). Returns
    (R, pooled_h, pooled_w, C). Works on chunks of RoIs whose gathered
    windows hold at most ``max_elements`` values."""
    h, w, c = feat.shape
    r = rois.shape[0]
    argmax = torch.full((r, pooled_h, pooled_w, c), -1, dtype=torch.int32,
                        device=feat.device)
    if r == 0 or c == 0:
        return argmax
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
    chunk = max(1, max_elements // (pooled_h * pooled_w * k * c))
    featf = feat.float()
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
        argmax[sl] = torch.where(ok, best, -1).to(torch.int32)
    return argmax


def roi_pool_scatter_reference(argmax, g, height, width):
    """Plain-PyTorch RoIPoolF gradient from the first-max index (the
    function of the backward kernel): dfeat[s, argmax[e], c] += g[s, e] for
    every element e = (r, ph, pw, c) with argmax[e] >= 0, by ``index_add_``
    into float32. argmax (R, PH, PW, C) int32; g (G, R, PH, PW, C) -> dfeat
    (G, height, width, C)."""
    c = argmax.shape[-1]
    n_seeds = g.shape[0]
    dfeat = torch.zeros((n_seeds, height * width * c), dtype=torch.float32,
                        device=argmax.device)
    flat = argmax.reshape(-1).long()
    keep = flat >= 0
    chan = torch.arange(argmax.numel(), device=argmax.device) % c
    index = (flat * c + chan)[keep]
    dfeat.index_add_(1, index, g.float().reshape(n_seeds, -1)[:, keep])
    return dfeat.view(n_seeds, height, width, c)


def roi_pool_backward_reference(feat, rois, g, pooled_h=7, pooled_w=7,
                                spatial_scale=0.125):
    """Plain-PyTorch RoIPoolF gradient by its definition: each bin's
    cotangent to its first max cell (``roi_pool_argmax_reference``), summed
    in float32 (``roi_pool_scatter_reference``). An empty bin and a bin
    whose max is not finite pass nothing back. g (G, R, PH, PW, C) ->
    dfeat (G, H, W, C)."""
    h, w, _ = feat.shape
    argmax = roi_pool_argmax_reference(feat, rois, pooled_h, pooled_w,
                                       spatial_scale)
    return roi_pool_scatter_reference(argmax, g, h, w)


def roi_pool_backward_cuda(argmax, g, height, width):
    """Launch the CUDA RoIPoolF backward kernel (the scatter) on the
    current stream.

    argmax: (R, PH, PW, C) contiguous int32 CUDA tensor, the forward's
    first-max index (``roi_pool_cuda(..., argmax=True)``); g:
    (G, R, PH, PW, C) contiguous float32 or bfloat16 on the same device.
    Returns dfeat (G, height, width, C) float32. The kernel reads the index
    and g with 16-byte loads where their size and base addresses allow it,
    one element a thread otherwise. The sums are float atomics: their last
    bits depend on the order the card adds in.
    ``roi_pool_backward_cuda.launches`` counts the kernel launches."""
    if not argmax.is_cuda:
        raise ValueError('roi_pool_backward_cuda needs a CUDA tensor')
    if argmax.dtype != torch.int32 or g.dtype not in _SUFFIX:
        raise ValueError('roi_pool_backward_cuda: the index must be int32 '
                         'and the cotangents float32 or bfloat16, got {} and '
                         '{}'.format(argmax.dtype, g.dtype))
    if argmax.dim() != 4 or not argmax.is_contiguous():
        raise ValueError('roi_pool_backward_cuda: the index must be a '
                         'contiguous (R, PH, PW, C) tensor, got shape {} '
                         'strides {}'.format(tuple(argmax.shape),
                                             argmax.stride()))
    if (g.device != argmax.device or g.dim() != 5
            or g.shape[1:] != argmax.shape or not g.is_contiguous()):
        raise ValueError('roi_pool_backward_cuda: g must be a contiguous '
                         '(G, {}) tensor on {}, got {}'.format(
                             ', '.join(map(str, argmax.shape)), argmax.device,
                             tuple(g.shape)))
    c = argmax.shape[-1]
    n_seeds = g.shape[0]
    dfeat = torch.zeros((n_seeds, height, width, c), dtype=torch.float32,
                        device=argmax.device)
    if argmax.numel() == 0 or n_seeds == 0:
        return dfeat
    fn, err_str = _kernel_fn(
        'roi_pool_bwd', 'roi_pool_bwd_' + _SUFFIX[g.dtype],
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 +
        [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(argmax.device).cuda_stream
    rc = fn(argmax.data_ptr(), g.data_ptr(), dfeat.data_ptr(), height, width,
            c, argmax.numel(), n_seeds, stream)
    if rc != 0:
        raise RuntimeError('roi_pool backward CUDA launch failed: {}'.format(
            err_str(rc).decode()))
    roi_pool_backward_cuda.launches += 1
    return dfeat


roi_pool_backward_cuda.launches = 0


def roi_align(feat, rois, pooled_h=7, pooled_w=7, spatial_scale=0.125,
              sampling_ratio=2, out_dtype=None):
    """Detectron RoIAlign (legacy, no half-pixel offset) with a static
    sampling grid. feat: (H, W, C) float32 or bfloat16; rois: (R, 5).
    Returns (R, pooled_h, pooled_w, C) in ``out_dtype`` (default: the
    feature dtype): the mean of ``sampling_ratio`` x ``sampling_ratio``
    bilinear samples per bin, computed in float32 and cast last. Forward
    only."""
    if sampling_ratio <= 0:
        raise ValueError('roi_align needs a static sampling grid: '
                         'sampling_ratio {} is not positive'.format(
                             sampling_ratio))
    if feat.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            'roi_align has no gradient yet: RoIAlign from an unfrozen body '
            '(TRAIN.FREEZE_CONV_BODY False, FPN) is queued in ROADMAP.md '
            '(queue 2, "K4 backward")')
    if feat.is_cuda:
        out = roi_align_cuda(feat, rois, pooled_h, pooled_w, spatial_scale,
                             sampling_ratio)
    elif feat.device.type == 'cpu':
        out = roi_align_reference(feat, rois, pooled_h, pooled_w,
                                  spatial_scale, sampling_ratio)
    else:
        raise ValueError('roi_align: unsupported device {}'.format(
            feat.device))
    return out.to(feat.dtype if out_dtype is None else out_dtype)


def _axis_samples(start, end, pooled, sr, limit):
    """The ``pooled * sr`` sample coordinates between the scaled RoI
    coordinates ``start`` and ``end`` (R,) on an axis of ``limit`` cells, in
    float32 and in the JAX function's order of operations. Returns (lower
    cell, upper cell, the upper cell's weight, validity as 0 / 1), each
    (R, pooled, sr). Divisors are 0-d tensors: a division by a Python
    number may be computed as a product with its reciprocal."""
    extent = (end - start).clamp(min=1.0)
    bin_size = extent / start.new_tensor(float(pooled))
    p = torch.arange(pooled, dtype=torch.float32, device=start.device)
    s = torch.arange(sr, dtype=torch.float32, device=start.device)
    bin_size = bin_size[:, None, None]
    coord = ((start[:, None, None] + p[None, :, None] * bin_size)
             + ((s[None, None, :] + 0.5) * bin_size)
             / start.new_tensor(float(sr)))
    valid = ((coord >= -1.0) & (coord <= float(limit))).float()
    clipped = coord.clamp(0.0, limit - 1.0)
    lower = torch.floor(clipped)
    c0 = lower.long()
    c1 = (c0 + 1).clamp(max=limit - 1)
    return c0, c1, clipped - lower, valid


def roi_align_reference(feat, rois, pooled_h=7, pooled_w=7,
                        spatial_scale=0.125, sampling_ratio=2, chunk=64):
    """Plain-PyTorch RoIAlign (mirrors the JAX ``roi_align_xla`` operation
    for operation), float32 out. Coordinates are not rounded; extents are
    floored at 1 in feature units; a sample counts iff -1 <= coord <= limit
    on both axes (a sample at exactly H counts, clipped to H - 1) and is
    multiplied by 0 otherwise, so a non-finite cell under a zero weight
    gives NaN; the samples of a bin are summed in row-major order and
    divided by their number. Works on chunks of ``chunk`` RoIs."""
    h, w, c = feat.shape
    r = rois.shape[0]
    sr = sampling_ratio
    if r == 0:
        return torch.zeros((0, pooled_h, pooled_w, c), dtype=torch.float32,
                           device=feat.device)
    scaled = rois[:, 1:5].float() * spatial_scale
    count = scaled.new_tensor(float(sr * sr))
    outs = []
    for i in range(0, r, chunk):
        sw, sh, ew, eh = scaled[i:i + chunk].unbind(1)
        y0, y1, ly, vy = _axis_samples(sh, eh, pooled_h, sr, h)
        x0, x1, lx, vx = _axis_samples(sw, ew, pooled_w, sr, w)
        acc = None
        for iy in range(sr):
            ya = y0[:, :, iy, None]                              # (r,PH,1)
            yb = y1[:, :, iy, None]
            wy = ly[:, :, iy, None, None]                      # (r,PH,1,1)
            for ix in range(sr):
                xa = x0[:, None, :, ix]                          # (r,1,PW)
                xb = x1[:, None, :, ix]
                wx = lx[:, None, :, ix, None]                  # (r,1,PW,1)
                val = (feat[ya, xa].float() * (1 - wy) * (1 - wx)
                       + feat[ya, xb].float() * (1 - wy) * wx
                       + feat[yb, xa].float() * wy * (1 - wx)
                       + feat[yb, xb].float() * wy * wx)     # (r,PH,PW,C)
                val = val * (vy[:, :, iy, None, None]
                             * vx[:, None, :, ix, None])
                acc = val if acc is None else acc + val
        outs.append(acc / count)
    return torch.cat(outs)


def roi_align_cuda(feat, rois, pooled_h=7, pooled_w=7, spatial_scale=0.125,
                   sampling_ratio=2):
    """Launch the CUDA RoIAlign kernel on the current stream.

    feat: (H, W, C) contiguous float32 or bfloat16 CUDA tensor, any C and
    any base address (``channels_per_load`` says which loads the kernel
    uses); rois: (R, 5) contiguous float32 on the same device. Returns
    float32. ``roi_align_cuda.launches`` counts the kernel launches."""
    if sampling_ratio <= 0:
        raise ValueError('roi_align_cuda: sampling_ratio {} is not '
                         'positive'.format(sampling_ratio))
    out, launched = launch_pool_forward(
        'roi_align', feat, rois, 5, pooled_h, pooled_w, spatial_scale,
        extra_ints=(sampling_ratio,), out_dtype=torch.float32)
    roi_align_cuda.launches += launched
    return out


roi_align_cuda.launches = 0


def roi_feature_boost(roi_feat, obn_scores):
    """Scale each RoI's features by its objectness score, with no gradient
    to the score. roi_feat: (R, ...); obn_scores: (R,) or (R, 1)."""
    s = obn_scores.reshape(obn_scores.shape[0], -1)[:, 0].detach()
    s = s.to(roi_feat.dtype)  # bf16 activations stay bf16
    return roi_feat * s.reshape((-1,) + (1,) * (roi_feat.dim() - 1))
