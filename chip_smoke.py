"""Smoke run of the PyTorch port on one NVIDIA GPU (sm_90a, an H100).

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:
  1. device: a CUDA card, its name and power limit, TF32 off;
  2. build every CUDA kernel of the paths from the sources in this
     checkout, one nvcc per source, all started together;
  3. each kernel against its plain PyTorch version on the card at the main
     paths' shapes (an (87, 119, 512) map -- a 375x500 image at scale 688
     -- and 2048 RoIs with edge cases), with its time, the plain version's
     time and its bound: the RoIPoolF forward bitwise in float32 and
     bfloat16, with and without its first-max index (the index bitwise
     too), on a ReLU map and on a map with NaN and infinite cells; the
     RoIPoolF backward (the scatter from that index) for 1 and 3 seed
     batches in both types, bitwise with integer cotangents against the
     plain scatter and the plain gradient by its definition (the routing),
     within 1e-5 |x| + 1e-6 sum|g| per cell with normal ones (float atomics
     add in another order than the plain version), all zeros for zero
     cotangents, timed beside one scatter_add_; the
     RoILoopPool forward bitwise in both types on the frame and the context
     rois of the same proposals plus edge rows (an inner box that covers the
     outer one, one-row and one-column interiors, an interior on bin edges
     among them), on a ReLU map, a signed map, an all-negative map (all
     zeros out) and a map with NaN and infinite cells;
  4. the flagship inference path at full width (dilated VGG16-C5, two
     4096-wide towers, 21 classes, bfloat16, random weights from a seed)
     through test_net -> im_detect_all over three synthetic images with
     ~2000 proposals each, counting kernel launches;
  5. the same images with the pool forced to its plain version: the
     detections must be identical to phase 4;
  6. flagship webly training at full width: 4 steps of train_model over
     four synthetic images (SOLVER.BASE_LR lowered to TRAIN_BASE_LR, see
     there), one step a bagging-mixup blend; finite losses,
     every trainable leaf moved and no body leaf, the forward kernel once
     per step and the backward kernel never;
  7. CSC training at full width: 3 steps, each image labelled with the
     two classes the untrained model scores highest and WSL.CPG_TAU
     lowered to 0 so that both are active seeds (at the configured 0.7
     a class scored below it is none, which the phase also checks); the backward
     kernel once per active seed, none past WSL.CSC_MAX_ITER; then the saliency maps and CSC weights of one
     image from the trained state with the pool's backward as the kernel
     and as the plain version, held to the tolerances of CSC_MAP_TOL;
  8. context inference at full width (one 4096-wide tower over the
     proposal, frame and context streams) through run_inference ->
     test_net_on_dataset -> test_net -> the VOC evaluator, over a synthetic
     VOC-style dataset (COCO json, VOC XML, a proposal pkl) written to a
     temporary directory and loaded by JsonDataset, the pixels handed over
     as arrays: RoIPoolF once and RoILoopPool twice per image, finite
     detections under the cap, mAP and CorLoc finite in [0, 1] (and 1 per
     class for the ground truth as detections); then the
     same images with RoILoopPool forced to its plain version: identical
     detections;
  9. context training at full width: 3 steps of train_model; finite
     losses, fc6, fc7, fc8c and fc8d_frame's weight moved (its bias
     cancels in fc8d and must not move), no body leaf moved, RoIPoolF once
     and RoILoopPool twice per step, the backward kernel never;
 10. the seg family's fcn mask head (core.config.SEG_FCN) at full width:
     inference through test_net -> im_detect_all -> forward_masks (RoIAlign
     on the <= 100 final boxes of each image) -> segm_results, one RLE per
     detection, each mask inside its expanded box and the image, the RLEs
     in detections.pkl, identical masks with RoIAlign forced to its plain
     version; then 3 training steps (RoIPoolF and RoIAlign once per step on
     the 2048 padded RoIs): finite losses, mask_loss_cls present, the
     gradient in every mask leaf;
 11. RoIAlign as the box transform (FAST_RCNN.ROI_XFORM_METHOD RoIAlign on
     the plain 2fc head): one image's scores finite and equal to the
     plain-version rerun;
 12. the seg family's deeplab mask head (core.config.SEG, the YAML's):
     inference through test_net -> forward_deeplab_masks ->
     segm_results_deeplab, and 3 training steps with the CPG seeds (the
     backward kernel once per seed), the seed loss and the dense-CRF
     consistency loss finite, every mask leaf moved.
The RoIAlign kernel is held against its plain version in phase 3 too: at
14x14 and 7x7 bins with 2x2 samples, float32 and bfloat16, bitwise, on the
2048 proposals plus edge rows (samples at exactly -1, H and W, boxes past
and off the map, a sub-cell box, padded all-zero rows) and on a map with
NaN and infinite cells (NaN in the same places); it is also timed at 14x14
on 100 of the RoIs, mask inference's shape.
``--profile`` adds stage times and torch.profiler's kernel tables for one
image, one flagship train step and one CSC train step, one context image
and one context train step, one SEG_FCN image and one SEG_FCN train step.
Every counted run also checks that the RoIPoolF forward wrote its
first-max index in each of its launches where the backward ran (CSC and SEG
training) and in none elsewhere (inference, frozen-body training).
The last lines are the kernel table (JSON), the card's
``nvidia-smi --query-gpu=name,power.limit`` line, and the result (JSON).
Imports nothing of JAX. Needs one card; exits non-zero without one.
"""

import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

MEM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
IMAGE_SIZES = [(375, 500), (500, 333), (480, 640)]
TRAIN_IMAGE_SIZES = IMAGE_SIZES + [(333, 500)]
NUM_PROPOSALS = 2000
# image-level class of each of the four training images: pairs share it
# (bagging-mixup draws a partner of the same class)
TRAIN_CLASSES = [3, 3, 8, 8]
# numpy seed of the flagship training phase's minibatches: with it the
# second of the four steps is a bagging-mixup blend (a test holds this)
FLAGSHIP_TRAIN_SEED = 3
# SOLVER.BASE_LR of both training phases. The weights are random, not the
# ImageNet VGG16 the configured 1e-3 is meant for: the clamped CE gradient
# (up to 1e4) times 1e-3 kills every ReLU of the random head in one step,
# after which all scores are uniform and every saliency map is zero.
TRAIN_BASE_LR = 1e-5
# Kernels against the plain pool inside the CSC step. Both sum floats
# with atomics, in an order that changes from run to run, and round the
# map's gradient to bfloat16 before 13 bfloat16 convolutions: a cell at the
# 0.1 threshold may fall on either side. At most this share of the
# binarised cells and of the CSC weights (beyond 0.05) may differ; the runs
# on an H100 showed none.
CSC_MAP_TOL = {'binary_share': 0.002, 'weight_share': 0.002}


def log(*args):
    print(*args, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError('torch.cuda.is_available() is False')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log('device:', torch.cuda.get_device_name(0), '|', smi)
    log('torch', torch.__version__, 'cuda', torch.version.cuda,
        '| matmul.allow_tf32 =', torch.backends.cuda.matmul.allow_tf32,
        '| cudnn.allow_tf32 =', torch.backends.cudnn.allow_tf32)
    return smi


def phase_build():
    from nafwebsod_torch.ops import _build
    t0 = time.time()
    names = ['roi_pool', 'roi_pool_bwd', 'roi_loop_pool', 'roi_align']
    reports = _build.build(names)
    for name, report in reports.items():
        log('nvcc', name, ':', report.strip().replace('\n', ' | '))
    for name in names:
        _build.load(name)
    log('build: %.1f s' % (time.time() - t0))


def k1_rois(rng, r, im_w, im_h):
    """Seeded MCG-like RoIs in blob coordinates: 8 px to the whole image,
    coordinates with x/8 exactly at .5, boxes past the map's edge, and
    degenerate boxes whose bins are empty."""
    x1 = rng.uniform(0, im_w - 8, r)
    y1 = rng.uniform(0, im_h - 8, r)
    bw = np.exp(rng.uniform(np.log(8), np.log(im_w), r))
    bh = np.exp(rng.uniform(np.log(8), np.log(im_h), r))
    rois = np.stack([np.zeros(r), x1, y1, x1 + bw, y1 + bh], 1)
    rois[:, 1:] = np.clip(rois[:, 1:], 0, [im_w - 1, im_h - 1] * 2)
    n = r // 16
    rois[:n, 1:] = rng.randint(0, min(im_w, im_h) // 8, (n, 4)) * 8 + 4.0
    rois[n:2 * n, 3:5] = rois[n:2 * n, 1:3] - rng.uniform(1, 60, (n, 2))
    rois[2 * n:3 * n, 3:5] = rois[2 * n:3 * n, 1:3]
    rois[3 * n:4 * n, 3:5] += rng.uniform(50, 400, (n, 2))   # past the map
    rois[4 * n] = [0, 0, 0, im_w - 1, im_h - 1]
    return rois.astype(np.float32)


def time_ms(fn, reps):
    """Median of ``reps`` CUDA-event timings of fn() after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def pool_bound_ms(feat, rois, others):
    """The larger of bytes / memory rate (the map, the RoIs and every
    tensor of ``others`` moved once) and this run's max operations (one
    per bin cell and channel) / the float32 rate. For 9-column RoIs the
    cells strictly inside the inner box are not counted."""
    from nafwebsod_torch.ops import roi_pool as rp
    nbytes = (feat.numel() * feat.element_size() + rois.numel() * 4
              + sum(t.numel() * t.element_size() for t in others))
    h, w, c = feat.shape
    q = rp._round_half_away(rois[:, 1:5].float().cpu() * 0.125).long()
    x1, y1, x2, y2 = q.unbind(1)
    hs, he = rp._bin_edges(y1, (y2 - y1 + 1).clamp(min=1), 7, h)
    ws, we = rp._bin_edges(x1, (x2 - x1 + 1).clamp(min=1), 7, w)
    cells = ((he - hs).clamp(min=0)[:, :, None] *
             (we - ws).clamp(min=0)[:, None, :]).sum().item()
    if rois.shape[1] == 9:
        qi = rp._round_half_away(rois[:, 5:9].float().cpu() * 0.125).long()
        ix1, iy1, ix2, iy2 = (v[:, None] for v in qi.unbind(1))
        hole_h = (torch.minimum(he, iy2) - torch.maximum(hs, iy1 + 1))
        hole_w = (torch.minimum(we, ix2) - torch.maximum(ws, ix1 + 1))
        cells -= (hole_h.clamp(min=0)[:, :, None] *
                  hole_w.clamp(min=0)[:, None, :]).sum().item()
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = cells * c / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ('bytes' if bytes_ms >= ops_ms
                                   else 'operations')


def phase_k1():
    """The RoIPoolF forward kernel against its plain version, without and
    with the first-max index, on a ReLU map and on a map with NaN and
    infinite cells."""
    from nafwebsod_torch.ops import roi_pool as rp
    rng = np.random.RandomState(0)
    rois = torch.from_numpy(k1_rois(rng, 2048, 917, 688)).cuda()
    base = torch.relu(torch.from_numpy(
        rng.randn(87, 119, 512).astype(np.float32))).cuda()
    non_finite = base.clone()
    non_finite[40, 60, 7] = float('nan')     # bins that pool to 0 and get
    non_finite[20, 30, 9] = float('inf')     # no index
    non_finite[50, 70, 11] = float('-inf')   # loses against the others
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        for kind, m in (('relu', base), ('non-finite', non_finite)):
            feat = m.to(dtype)
            got, index = rp.roi_pool_cuda(feat, rois, argmax=True)
            want = rp.roi_pool_reference(feat, rois)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not torch.equal(got, want):
                raise AssertionError('K1 %s (%s map) differs from the plain '
                                     'version: max abs err %g' % (dtype, kind,
                                                                  err))
            if not torch.equal(index, rp.roi_pool_argmax_reference(feat,
                                                                   rois)):
                raise AssertionError('K1 %s (%s map): the first-max index '
                                     'differs from the plain version' % (
                                         dtype, kind))
            if not torch.equal(rp.roi_pool_cuda(feat, rois), want):
                raise AssertionError('K1 %s (%s map) without the index '
                                     'differs from the plain version' % (
                                         dtype, kind))
        feat = base.to(dtype)
        got, index = rp.roi_pool_cuda(feat, rois, argmax=True)
        ms = time_ms(lambda: rp.roi_pool_cuda(feat, rois), 50)
        ms_index = time_ms(lambda: rp.roi_pool_cuda(feat, rois, argmax=True),
                           50)
        plain_ms = time_ms(lambda: rp.roi_pool_reference(feat, rois), 3)
        bound_ms, bound_by = pool_bound_ms(feat, rois, [got])
        bound_index_ms, _ = pool_bound_ms(feat, rois, [got, index])
        log('K1 %s (87,119,512) R=2048: equal on the relu and non-finite '
            'maps (the index too), %d channels a load, kernel %.4f ms '
            '(with the index %.4f ms), plain %.4f ms, bound %.4f ms (%s; with '
            'the index %.4f ms), empty-bin share %.3f' % (
                str(dtype), rp.channels_per_load(feat), ms, ms_index,
                plain_ms, bound_ms, bound_by, bound_index_ms,
                (index == -1).all(-1).float().mean().item()))
        if dtype == torch.bfloat16:  # the flagship's compute dtype
            row = {'name': 'roi_pool_fwd', 'route': 'cuda',
                   'source': 'nafwebsod_torch/ops/csrc/roi_pool.cu',
                   'replaces':
                       'nafwebsod_tpu/ops/pallas/roi_pool_pallas.py:181',
                   'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                   'bound_ms': bound_ms, 'bound_by': bound_by,
                   # no single PyTorch call computes RoIPoolF
                   'library_ms': None,
                   # the launches of CSC and SEG training write the index
                   'ms_with_index': ms_index,
                   'bound_ms_with_index': bound_index_ms}
    return row


def scatter_bound_ms(index, g, dfeat):
    """The bound of the scatter's interface, which is not the function's:
    the larger of bytes / memory rate (the saved index and g read once,
    dfeat written once) and this run's additions (nonzero cotangents with
    an index) / the float32 rate."""
    nbytes = (index.numel() * 4 + g.numel() * g.element_size()
              + dfeat.numel() * 4)
    adds = ((index >= 0)[None] & (g != 0)).sum().item()
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = adds / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ('bytes' if bytes_ms >= ops_ms
                                   else 'operations')


def phase_k3():
    """The RoIPoolF backward kernel (the scatter from K1's first-max index)
    against its plain version. Its bound is the function's (map, RoIs and g
    in, dfeat out, as for the first design, which read no index); the
    index's own cost shows in ``ms_with_forward_index``: K1 with the index
    and K3 together, less K1 without it."""
    from nafwebsod_torch.ops import roi_pool as rp
    rng = np.random.RandomState(0)
    rois = torch.from_numpy(k1_rois(rng, 2048, 917, 688)).cuda()
    base = torch.relu(torch.from_numpy(
        rng.randn(87, 119, 512).astype(np.float32))).cuda()
    base[40, 60, 7] = float('nan')    # bins the forward maps to 0:
    base[20, 30, 9] = float('inf')    # nothing may flow back to them
    ints = torch.from_numpy(rng.randint(-3, 4, (3, 2048, 7, 7, 512))
                            .astype(np.float32)).cuda()
    normal = torch.randn(3, 2048, 7, 7, 512, device='cuda',
                         generator=torch.Generator('cuda').manual_seed(0))
    h, w, c = base.shape
    # the library call's flat index: the channel's cell, or a spare slot
    chan = torch.arange(c, device='cuda')
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        feat = base.to(dtype)
        _, index = rp.roi_pool_cuda(feat, rois, argmax=True)
        if not torch.equal(index, rp.roi_pool_argmax_reference(feat, rois)):
            raise AssertionError('K3 %s: the forward\'s index differs from '
                                 'the plain version' % dtype)
        flat = torch.where(index >= 0, index.long() * c + chan,
                           h * w * c).reshape(1, -1)
        for seeds in (1, 3):
            g_int = ints[:seeds].to(dtype)
            got = rp.roi_pool_backward_cuda(index, g_int, h, w)
            torch.cuda.synchronize()
            if not (torch.equal(got, rp.roi_pool_scatter_reference(
                    index, g_int, h, w)) and torch.equal(
                        got, rp.roi_pool_backward_reference(feat, rois,
                                                            g_int))):
                raise AssertionError(
                    'K3 %s G=%d routes differently from the plain version'
                    % (dtype, seeds))
            if not got.any():
                raise AssertionError('K3 returned all zeros')
            g = normal[:seeds].to(dtype)
            got = rp.roi_pool_backward_cuda(index, g, h, w)
            want = rp.roi_pool_scatter_reference(index, g, h, w)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            # two float32 sums of the same terms in different orders: the
            # sum of the terms' magnitudes bounds every partial sum
            mass = rp.roi_pool_scatter_reference(index, g.abs(), h, w)
            if ((got - want).abs() > 1e-5 * want.abs() + 1e-6 * mass).any():
                raise AssertionError('K3 %s G=%d differs from the plain '
                                     'version: max abs err %g' % (
                                         dtype, seeds, err))
            zeros = torch.zeros_like(g)
            if rp.roi_pool_backward_cuda(index, zeros, h, w).any():
                raise AssertionError('K3: zero cotangents gave a gradient')
            ms = time_ms(lambda: rp.roi_pool_backward_cuda(index, g, h, w),
                         50)
            zero_ms = time_ms(lambda: rp.roi_pool_backward_cuda(
                index, zeros, h, w), 10)
            plain_ms = time_ms(lambda: rp.roi_pool_scatter_reference(
                index, g, h, w), 3)
            # one scatter_add_ of float32 cotangents through a prepared
            # int64 flat index (the spare slot takes the -1 entries)
            lib_index = flat.expand(seeds, -1).contiguous()
            gf = g.float().reshape(seeds, -1)
            library_ms = time_ms(lambda: torch.zeros(
                seeds, h * w * c + 1, device='cuda').scatter_add_(
                    1, lib_index, gf), 20)
            del lib_index, gf
            fwd_ms = time_ms(lambda: rp.roi_pool_cuda(feat, rois), 50)
            pair_ms = time_ms(lambda: rp.roi_pool_backward_cuda(
                rp.roi_pool_cuda(feat, rois, argmax=True)[1], g, h, w), 50)
            bound_ms, bound_by = pool_bound_ms(feat, rois, [g, got])
            bound_index_ms, _ = scatter_bound_ms(index, g, got)
            log('K3 %s (87,119,512) R=2048 G=%d: integer cotangents equal, '
                'normal ones max abs err %.3g (within 1e-5 |x| + 1e-6 sum|g|), '
                'kernel %.4f ms (zero cotangents %.4f ms; with the index\'s '
                'cost in K1 %.4f ms), plain %.4f ms, scatter_add_ %.4f ms, '
                'bound %.4f ms (%s; of the index interface %.4f ms)' % (
                    str(dtype), seeds, err, ms, zero_ms, pair_ms - fwd_ms,
                    plain_ms, library_ms, bound_ms, bound_by,
                    bound_index_ms))
            if dtype == torch.bfloat16 and seeds == 1:  # the CSC step's call
                row = {'name': 'roi_pool_bwd', 'route': 'cuda',
                       'source': 'nafwebsod_torch/ops/csrc/roi_pool_bwd.cu',
                       'replaces':
                           'nafwebsod_tpu/ops/pallas/roi_pool_pallas.py:384',
                       'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                       'bound_ms': bound_ms, 'bound_by': bound_by,
                       'library_ms': library_ms,
                       'ms_with_forward_index': pair_ms - fwd_ms,
                       'bound_ms_index_interface': bound_index_ms}
    return row


# Edge rows for RoILoopPool on the (87, 119) map of a 688x917 blob: (batch,
# outer box, inner box) in blob coordinates.
K2_EDGE_ROIS = [
    [0, 100, 100, 500, 400, 100, 100, 500, 400],    # inner box == outer box
    [0, 100, 100, 500, 400, 300, 200, 300, 200],    # a one-cell inner box
    [0, 100, 100, 500, 400, 300, 200, 308, 208],    # two cells: no interior
    [0, 0, 0, 916, 687, 0, 0, 916, 687],     # the image: only its border
    [0, 800, 600, 916, 687, 800, 600, 916, 687],    # clipped at the corner
    [0, 700, 500, 1500, 1300, 800, 600, 1400, 1200],    # past the map
    [0, 2000, 2000, 2100, 2100, 2020, 2020, 2080, 2080],    # off the map
    [0, 400, 300, 200, 100, 380, 280, 220, 120],    # inverted: extents 1
    [0, 0, 0, 0, 0, 0, 0, 0, 0],                    # a padded row
    [0, 200, 200, 400, 300, 100, 100, 500, 400],    # inner covers outer: 0
    [0, 100, 100, 500, 400, 150, 200, 450, 216],    # one open row (26)
    [0, 100, 100, 500, 400, 200, 150, 216, 350],    # one open column (26)
    # cells 8-63 on both axes, bins of 8 cells; the open interior is
    # columns 16-55 and rows 24-47, exactly bins 1-5 and 2-4
    [0, 64, 64, 504, 504, 120, 184, 448, 384],
]


def phase_k2():
    """The RoILoopPool kernel against its plain version."""
    from nafwebsod_torch.ops import context as ctx
    rng = np.random.RandomState(0)
    proposals = torch.from_numpy(k1_rois(rng, 2048, 917, 688)).cuda()
    signed = torch.from_numpy(
        rng.randn(87, 119, 512).astype(np.float32)).cuda()
    edge = torch.tensor(K2_EDGE_ROIS, dtype=torch.float32, device='cuda')
    streams = dict(zip(('frame', 'context'),
                       ctx.roi_context(proposals, 688, 917, 1.8)))
    non_finite = signed.clone()
    non_finite[40, 60, 7] = float('nan')     # a ring with a NaN or +inf
    non_finite[20, 30, 9] = float('inf')     # gives 0, as the plain version
    non_finite[50, 70, 11] = float('-inf')   # loses against the 0 floor
    maps = {'relu': torch.relu(signed), 'signed': signed,
            'negative': -signed.abs() - 1, 'non-finite': non_finite}
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for stream, rois9 in streams.items():
            rois9 = torch.cat([rois9, edge]).contiguous()
            for kind, base in maps.items():
                feat = base.to(dtype)
                got = ctx.roi_loop_pool_cuda(feat, rois9)
                want = ctx.roi_loop_pool_reference(feat, rois9)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        'K2 %s %s rois, %s map differs from the plain '
                        'version: max abs err %g' % (
                            dtype, stream, kind,
                            (got.float() - want.float()).abs().max().item()))
                if not torch.isfinite(got).all() or (got < 0).any():
                    raise AssertionError('K2 gave a negative or non-finite '
                                         'value (%s map)' % kind)
                if kind == 'negative' and got.any():
                    raise AssertionError('K2: an all-negative map must pool '
                                         'to 0 everywhere')
                if got[len(got) - len(K2_EDGE_ROIS) + 9].any():
                    raise AssertionError('K2: an inner box that covers the '
                                         'outer box leaves no ring')
            feat = maps['relu'].to(dtype)
            got = ctx.roi_loop_pool_cuda(feat, rois9)
            want = ctx.roi_loop_pool_reference(feat, rois9)
            err = (got.float() - want.float()).abs().max().item()
            ms = time_ms(lambda: ctx.roi_loop_pool_cuda(feat, rois9), 50)
            plain_ms = time_ms(
                lambda: ctx.roi_loop_pool_reference(feat, rois9), 3)
            bound_ms, bound_by = pool_bound_ms(feat, rois9, [got])
            log('K2 %s (87,119,512) %s rois R=%d: equal on the relu, signed, '
                'negative and non-finite maps, kernel %.4f ms, plain %.4f '
                'ms, bound %.4f ms (%s), all-zero-bin share %.3f' % (
                    str(dtype), stream, rois9.shape[0], ms, plain_ms,
                    bound_ms, bound_by,
                    (want == 0).all(-1).float().mean().item()))
            if dtype == torch.bfloat16:  # the context family's compute dtype
                rows[stream] = (err, ms, plain_ms, bound_ms, bound_by)
    # a path launches the kernel once with the frame and once with the
    # context rois: the row's numbers are the mean of the two launches
    frame, context = rows['frame'], rows['context']
    return {'name': 'roi_loop_pool_fwd', 'route': 'cuda',
            'source': 'nafwebsod_torch/ops/csrc/roi_loop_pool.cu',
            'replaces':
                'nafwebsod_tpu/ops/pallas/roi_loop_pool_pallas.py:120',
            'max_abs_err': max(frame[0], context[0]),
            'ms': (frame[1] + context[1]) / 2,
            'plain_ms': (frame[2] + context[2]) / 2,
            'bound_ms': (frame[3] + context[3]) / 2,
            'bound_by': context[4],
            # no single PyTorch call computes a ring max pool
            'library_ms': None,
            'ms_frame_rois': frame[1], 'ms_context_rois': context[1]}


# Edge rows for RoIAlign on the (87, 119) map of a 688x917 blob at scale
# 1/8 with 2 x 2 samples a bin. A box of 56 (14 bins) or 28 (7 bins) cells
# has a bin of 4 cells and samples at start + 4 p + 1 and + 3: exact in
# float32, so a sample can sit at exactly -1, 87 or 119.
K4_EDGE_ROIS = [
    [0, 800, 600, 1200, 900],       # past the right and the bottom edge
    [0, -16, 256, 432, 704],        # 14 bins: x from -1, y to H, exactly
    [0, 512, -16, 960, 432],        # 14 bins: x to W, y from -1, exactly
    [0, -16, 480, 208, 704],        # 7 bins: x from -1, y to H, exactly
    [0, 736, -16, 960, 208],        # 7 bins: x to W, y from -1, exactly
    [0, 100.3, 100.7, 101.1, 102.9],    # inside one cell: extents floored at 1
    [0, 400, 300, 200, 100],        # inverted: extents floored at 1
    [0, 2000, 2000, 2100, 2100],    # off the map: every sample counts 0
    [0, -500, -500, -100, -100],    # off the map on the other side
    [0, 0, 0, 916, 687],            # the image: 56 distinct rows, columns
    [0, 320, 240, 324, 244],        # in cell (30, 40): 14x14's samples all
    #                                 on cells 30-31 and 40-41
    [0, 0, 0, 0, 0], [0, 0, 0, 0, 0],   # padded rows of a training batch
]


def align_bound_ms(feat, rois, out, sr):
    """The larger of bytes / memory rate (the map and the RoIs read once,
    the float32 output written once) and operations / the float32 rate: per
    output and sample 8 products and 3 sums for the four corners, the
    validity product and the accumulation, and one division per output."""
    nbytes = (feat.numel() * feat.element_size() + rois.numel() * 4
              + out.numel() * out.element_size())
    ops = out.numel() * (13 * sr * sr + 1)
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ('bytes' if bytes_ms >= ops_ms
                                   else 'operations')


def same_with_nans(got, want):
    """Equal where both are numbers, NaN in the same places."""
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan], want[~nan]))


def phase_k4():
    """The RoIAlign kernel against its plain version."""
    from nafwebsod_torch.ops import roi_pool as rp
    rng = np.random.RandomState(0)
    rois = torch.cat([
        torch.from_numpy(k1_rois(rng, 2048, 917, 688)),
        torch.tensor(K4_EDGE_ROIS, dtype=torch.float32)]).cuda()
    signed = torch.from_numpy(
        rng.randn(87, 119, 512).astype(np.float32)).cuda()
    non_finite = signed.clone()
    non_finite[40, 60, 7] = float('nan')    # a NaN or an infinity under a
    non_finite[20, 30, 9] = float('inf')    # zero weight gives NaN in both
    non_finite[86, 118, 11] = float('-inf')
    maps = {'relu': torch.relu(signed), 'signed': signed,
            'non-finite': non_finite}
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        for res in (14, 7):
            for kind, base in maps.items():
                feat = base.to(dtype)
                got = rp.roi_align_cuda(feat, rois, res, res, 0.125, 2)
                want = rp.roi_align_reference(feat, rois, res, res, 0.125, 2)
                torch.cuda.synchronize()
                if got.dtype != torch.float32 or not same_with_nans(got,
                                                                    want):
                    raise AssertionError(
                        'K4 %s %dx%d, %s map differs from the plain version: '
                        'max abs err %g' % (
                            dtype, res, res, kind, torch.nan_to_num(
                                got - want, nan=float('inf')).abs().max()))
                if kind != 'non-finite' and not torch.isfinite(got).all():
                    raise AssertionError('K4 gave a non-finite value on a '
                                         'finite map (%s)' % kind)
            feat = maps['relu'].to(dtype)
            got = rp.roi_align_cuda(feat, rois, res, res, 0.125, 2)
            want = rp.roi_align_reference(feat, rois, res, res, 0.125, 2)
            n_edge = len(K4_EDGE_ROIS)
            if got[-n_edge + 7:-n_edge + 9].any():
                raise AssertionError('K4: a box off the map must pool to 0')
            err = (got - want).abs().max().item()
            ms = time_ms(lambda: rp.roi_align_cuda(feat, rois, res, res,
                                                   0.125, 2), 50)
            plain_ms = time_ms(lambda: rp.roi_align_reference(
                feat, rois, res, res, 0.125, 2), 2)
            bound_ms, bound_by = align_bound_ms(feat, rois, got, 2)
            log('K4 %s (87,119,512) R=%d %dx%d sr=2: equal on the relu, '
                'signed and non-finite maps, kernel %.4f ms, plain %.4f ms, '
                'bound %.4f ms (%s)' % (
                    str(dtype), rois.shape[0], res, res, ms, plain_ms,
                    bound_ms, bound_by))
            if dtype == torch.bfloat16 and res == 14:  # the mask head's call
                # mask inference: the <= 100 final boxes of an image
                boxes = rois[:2048:20][:100].contiguous()
                ms_100 = time_ms(lambda: rp.roi_align_cuda(
                    feat, boxes, res, res, 0.125, 2), 50)
                bound_100, _ = align_bound_ms(
                    feat, boxes, rp.roi_align_cuda(feat, boxes, res, res,
                                                   0.125, 2), 2)
                log('K4 %s (87,119,512) R=100 %dx%d sr=2: kernel %.4f ms, '
                    'bound %.4f ms' % (str(dtype), res, res, ms_100,
                                       bound_100))
                row = {'name': 'roi_align_fwd', 'route': 'cuda',
                       'source': 'nafwebsod_torch/ops/csrc/roi_align.cu',
                       'replaces':
                           'nafwebsod_tpu/ops/pallas/roi_align_pallas.py:132',
                       'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                       'bound_ms': bound_ms, 'bound_by': bound_by,
                       # none: F.grid_sample pads with zeros or the border
                       # where RoIAlign zeroes outside [-1, H] and clamps
                       # inside, wants the map once per RoI, and leaves the
                       # mean over a bin's samples to a second call
                       'library_ms': None,
                       'ms_100_boxes': ms_100,
                       'bound_ms_100_boxes': bound_100}
    return row


def synthetic_roidb(seed, pixel_means, sizes=IMAGE_SIZES, min_side=8):
    """Seeded uint8 BGR images of VOC-like sizes with ~2000 MCG-like
    proposals and objectness each. The pixels are 16-px blocks plus noise
    of a few units around the pixel means: the random-weight network has
    zero biases, so its logits scale with the pixel amplitude, and at the
    amplitude of a photograph both softmaxes saturate and leave a handful
    of detections per image. The proposals' sides start at ``min_side``
    pixels."""
    rng = np.random.RandomState(seed)
    roidb = []
    for i, (h, w) in enumerate(sizes):
        coarse = rng.uniform(-6, 6, (h // 16 + 2, w // 16 + 2, 3))
        im = np.kron(coarse, np.ones((16, 16, 1)))[:h, :w]
        im = np.clip(pixel_means.reshape(1, 1, 3) + im +
                     rng.randn(h, w, 3) * 2, 0, 255).astype(np.uint8)
        x1 = rng.uniform(0, w - 8, NUM_PROPOSALS)
        y1 = rng.uniform(0, h - 8, NUM_PROPOSALS)
        bw = np.exp(rng.uniform(np.log(min_side), np.log(w), NUM_PROPOSALS))
        bh = np.exp(rng.uniform(np.log(min_side), np.log(h), NUM_PROPOSALS))
        boxes = np.stack([x1, y1, np.minimum(x1 + bw, w - 1),
                          np.minimum(y1 + bh, h - 1)], 1)
        boxes[0] = [0, 0, w - 1, h - 1]
        roidb.append({'image': im, 'id': i,
                      'boxes': np.round(boxes).astype(np.float32),
                      'obn_scores': rng.rand(NUM_PROPOSALS, 1)
                      .astype(np.float32)})
    return roidb


def check_detections(all_boxes, num_images, limit):
    for i in range(num_images):
        dets = [np.asarray(all_boxes[j][i]) for j in range(1, 21)]
        for d in dets:
            if d.ndim != 2 or d.shape[1] != 5 or d.dtype != np.float32:
                raise AssertionError('class list of shape %s' % (d.shape,))
            if not np.isfinite(d).all():
                raise AssertionError('non-finite detections')
        scores = np.concatenate([d[:, 4] for d in dets])
        if scores.size > limit and (np.sort(scores)[-limit - 1]
                                    != np.sort(scores)[-limit]):
            raise AssertionError('%d detections > %d without a tie' % (
                scores.size, limit))
        if scores.size == 0:
            raise AssertionError('image %d has no detections' % i)


def phase_slice():
    from nafwebsod_torch.core.config import FLAGSHIP, cfg, merge_cfg_from_cfg
    from nafwebsod_torch.engine import test as infer
    from nafwebsod_torch.engine.test_engine import (
        initialize_model_from_cfg, test_net)
    from nafwebsod_torch.ops import roi_pool as rp

    merge_cfg_from_cfg(FLAGSHIP)
    model = initialize_model_from_cfg()          # the card, seed RNG_SEED
    assert model.spec.compute_dtype == 'bfloat16'
    assert model.spec.hidden_dim == 4096 and model.spec.num_classes == 21
    roidb = synthetic_roidb(1, cfg.PIXEL_MEANS)

    # scores of the full proposal set are finite, with the bg column first
    e = roidb[0]
    scores, _, _ = infer.im_detect_bbox(model, e['image'], cfg.TEST.SCALE,
                                        cfg.TEST.MAX_SIZE, e['boxes'],
                                        e['obn_scores'])
    if scores.shape != (NUM_PROPOSALS, 21) or not np.isfinite(scores).all():
        raise AssertionError('bad scores %s' % (scores.shape,))
    if not np.array_equal(scores[:, 0], scores[:, 1]):
        raise AssertionError('background column is not class 1')

    test_net(model, roidb[:1])                   # warm-up image
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    all_boxes, _, _ = test_net(model, roidb)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts()[0]
    if launches != len(roidb):
        raise AssertionError('K1 launched %d times for %d images' % (
            launches, len(roidb)))
    check_detections(all_boxes, len(roidb), int(cfg.TEST.DETECTIONS_PER_IM))
    n_det = [sum(len(all_boxes[j][i]) for j in range(1, 21))
             for i in range(len(roidb))]
    log('slice: %d images, %.2f ms/image (host clock, after a warm-up '
        'image), peak device memory %.0f MiB, detections per image %s, '
        'K1 launches %d' % (
            len(roidb), wall / len(roidb) * 1e3,
            torch.cuda.max_memory_allocated() / 2 ** 20, n_det, launches))

    # phase 5: the same run with the pool forced to the plain version
    kernel = rp.roi_pool_cuda
    rp.roi_pool_cuda = lambda *a, argmax=False: rp.roi_pool_reference(*a)
    try:
        plain_boxes, _, _ = test_net(model, roidb)
    finally:
        rp.roi_pool_cuda = kernel
    if kernel.launches != launches:
        raise AssertionError('the plain run launched the kernel')
    for j in range(1, 21):
        for i in range(len(roidb)):
            if not np.array_equal(all_boxes[j][i], plain_boxes[j][i]):
                raise AssertionError(
                    'class %d image %d: kernel and plain pool differ' % (j, i))
    log('plain pool on the card: identical detections')
    if '--profile' in sys.argv:
        profile_image(model, roidb[0])
    return launches


def train_roidb(pixel_means):
    """The four synthetic training images: the proposals of
    ``synthetic_roidb`` with the first row marked as ground truth of the
    image's class."""
    roidb = synthetic_roidb(2, pixel_means, TRAIN_IMAGE_SIZES)
    for entry, cls in zip(roidb, TRAIN_CLASSES):
        entry['gt_classes'] = np.zeros(len(entry['boxes']), np.int32)
        entry['gt_classes'][0] = cls
    return roidb


def reset_counts():
    from nafwebsod_torch.ops import context as ctx
    from nafwebsod_torch.ops import roi_pool as rp
    rp.roi_pool_cuda.launches = 0
    rp.roi_pool_cuda.argmax_launches = 0
    rp.roi_pool_backward_cuda.launches = 0
    ctx.roi_loop_pool_cuda.launches = 0
    rp.roi_align_cuda.launches = 0


# RoIPoolF forward launches that wrote the first-max index, one entry per
# counted run (read_counts)
INDEX_LAUNCHES = []


def read_counts():
    """Launches of (RoIPoolF forward, RoIPoolF backward, RoILoopPool,
    RoIAlign) since reset_counts(). Fails unless the RoIPoolF forward wrote
    its first-max index exactly where a backward reads it: in every launch
    of a run with RoIPoolF backward launches (the CPG seeds of CSC and SEG
    training), in none of any other run (inference, frozen-body
    training)."""
    from nafwebsod_torch.ops import context as ctx
    from nafwebsod_torch.ops import roi_pool as rp
    counts = (rp.roi_pool_cuda.launches, rp.roi_pool_backward_cuda.launches,
              ctx.roi_loop_pool_cuda.launches, rp.roi_align_cuda.launches)
    index = rp.roi_pool_cuda.argmax_launches
    if index != (counts[0] if counts[1] else 0):
        raise AssertionError('RoIPoolF forward wrote its index in %d of %d '
                             'launches with %d backward launches' % (
                                 index, counts[0], counts[1]))
    INDEX_LAUNCHES.append(index)
    return counts


def check_leaves_moved(model, before, unmoved=(), may_stay=()):
    """Every head leaf changed and no body leaf did; the head leaves in
    ``unmoved`` must not have changed either, those in ``may_stay`` may or
    may not have. Returns the leaves of ``may_stay`` that changed."""
    stayed = []
    for key, value in model.state_dict().items():
        moved = not torch.equal(value, before[key])
        if (key.startswith('body.') or key in unmoved) and moved:
            raise AssertionError('leaf %s changed' % key)
        if key in may_stay:
            stayed.extend([key] if moved else [])
        elif not key.startswith('body.') and key not in unmoved and not moved:
            raise AssertionError('trainable leaf %s did not change' % key)
    return stayed


def log_steps(name, records):
    steps = [r['step_s'] * 1e3 for r in records]
    log('%s: %d steps, losses %s, step ms (host clock, to the loss on the '
        'host) %s, after the first: median %.1f; minibatch + upload ms %s; '
        'peak device memory %.0f MiB' % (
            name, len(records), ['%.4f' % r['loss'] for r in records],
            ['%.1f' % t for t in steps],
            statistics.median(steps[1:]) if steps[1:] else float('nan'),
            ['%.1f' % (r['data_s'] * 1e3) for r in records],
            torch.cuda.max_memory_allocated() / 2 ** 20))


def phase_train_flagship():
    """Phase 6. Returns the forward kernel's launches."""
    from nafwebsod_torch.core.config import (FLAGSHIP, cfg,
                                             merge_cfg_from_cfg, reset_cfg)
    from nafwebsod_torch.engine.test_engine import initialize_model_from_cfg
    from nafwebsod_torch.engine.train import train_model

    reset_cfg()
    merge_cfg_from_cfg(FLAGSHIP)
    cfg.RNG_SEED = FLAGSHIP_TRAIN_SEED
    cfg.SOLVER.BASE_LR = TRAIN_BASE_LR
    roidb = train_roidb(cfg.PIXEL_MEANS)
    before = {k: v.clone() for k, v in
              initialize_model_from_cfg().state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    model, opt_state, records = train_model(roidb, max_iters=4)
    torch.cuda.synchronize()
    fwd, bwd, ring, align = read_counts()
    spec = model.spec
    assert spec.compute_dtype == 'bfloat16' and spec.hidden_dim == 4096
    assert spec.num_classes == 21 and spec.freeze_conv_body
    for r in records:
        for key in ('loss', 'loss_cls', 'loss_cls_noise',
                    'class_weight_mean'):
            if not np.isfinite(r[key]):
                raise AssertionError('iter %d: %s = %r' % (
                    r['iter'], key, r[key]))
    if [r['mixup'] for r in records] != [False, True, False, False]:
        raise AssertionError('mixup steps: %s' % [r['mixup']
                                                  for r in records])
    check_leaves_moved(model, before)
    if (fwd, bwd, ring, align) != (len(records), 0, 0, 0):
        raise AssertionError('flagship training launched K1 %d times, K3 %d '
                             'times, K2 %d times and K4 %d times in %d steps'
                             % (fwd, bwd, ring, align, len(records)))
    log_steps('flagship training (2048 padded RoIs, step 1 a mixup blend)',
              records)
    log('flagship training: class_weight_mean %s, K1 launches %d, K3 '
        'launches %d' % (['%.4f' % r['class_weight_mean'] for r in records],
                         fwd, bwd))
    if '--profile' in sys.argv:
        profile_train_step('flagship', model, opt_state, roidb)
    return fwd


def device_batch(model, blobs):
    from nafwebsod_torch.core.config import cfg
    from nafwebsod_torch.parallel import train_step as ts
    return ts.to_device_batch(
        ts.stack_minibatches([blobs], cfg.TPU.SIZE_BUCKET_MULTIPLE),
        model.device)


def image_scores(model, batch):
    """The (C,) image-level class scores of one training batch, without
    dropout."""
    from nafwebsod_torch.models import heads
    return heads.cls_pred(model.forward_test(
        batch['image'], batch['rois'], batch['obn_scores'],
        batch['valid_mask'])['rois_pred'])[0]


def csc_maps_and_weights(model, batch, seed):
    """(saliency maps, CSC weights) of one image, with dropout from
    ``seed``."""
    from nafwebsod_torch.ops import cpg as cpg_ops
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    maps, idx, keep = model.forward_cpg_maps(batch, gen)
    cls_prob = image_scores(model, batch)[None]
    w, _, _ = cpg_ops.csc_weights(
        maps, idx, keep, batch['rois'], batch['labels_oh'], cls_prob,
        fg_threshold=model.spec.csc_fg_threshold,
        valid_mask=batch['valid_mask'])
    return maps, keep, w


def label_with_top_classes(name, roidb):
    """Label each image with the two classes the cfg's untrained model
    scores highest on it, so that the CPG seeds' gradients are not all zero
    (the random head's class softmax is nearly one-hot). Returns that
    model's state dict, what a training run from the cfg's seed starts
    from."""
    from nafwebsod_torch.engine.test_engine import initialize_model_from_cfg
    from nafwebsod_torch.engine.train import build_minibatch
    fresh = initialize_model_from_cfg()
    for i, entry in enumerate(roidb):
        batch = device_batch(fresh, build_minibatch(
            roidb, i, np.random.RandomState(i)))
        top = image_scores(fresh, batch).topk(2)
        entry['gt_classes'][:2] = (top.indices + 1).tolist()
        log('%s image %d: labelled classes %s (untrained scores %s)' % (
            name, i, entry['gt_classes'][:2].tolist(),
            ['%.3g' % v for v in top.values.tolist()]))
    return {k: v.clone() for k, v in fresh.state_dict().items()}


def phase_train_csc():
    """Phase 7. Returns (forward launches, backward launches) of the three
    training steps."""
    from nafwebsod_torch.core.config import (CSC, cfg, merge_cfg_from_cfg,
                                             reset_cfg)
    from nafwebsod_torch.engine.test_engine import initialize_model_from_cfg
    from nafwebsod_torch.engine.train import build_minibatch, train_model
    from nafwebsod_torch.ops import roi_pool as rp
    from nafwebsod_torch.parallel import train_step as ts

    reset_cfg()
    merge_cfg_from_cfg(CSC)
    cfg.SOLVER.BASE_LR = TRAIN_BASE_LR
    tau = cfg.WSL.CPG_TAU
    cfg.WSL.CPG_TAU = 0.0
    log('CSC training: WSL.CPG_TAU lowered from %s to 0.0 -- both labelled '
        'classes of an image (at most TPU.CPG_MAX_GT = %d) are active seeds'
        % (tau, cfg.TPU.CPG_MAX_GT))
    roidb = train_roidb(cfg.PIXEL_MEANS)
    before = label_with_top_classes('CSC', roidb)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    model, opt_state, records = train_model(roidb, max_iters=3)
    torch.cuda.synchronize()
    fwd, bwd, _, _ = read_counts()
    spec = model.spec
    assert spec.compute_dtype == 'bfloat16' and spec.hidden_dim == 4096
    assert spec.csc and spec.box_head == 'vgg16_2fc'
    for r in records:
        for key in ('loss', 'loss_cls_pos', 'loss_cls_neg'):
            if not np.isfinite(r[key]):
                raise AssertionError('iter %d: %s = %r' % (
                    r['iter'], key, r[key]))
    check_leaves_moved(model, before)
    active = 2 * len(records)     # both labels of every image, tau = 0
    if fwd != len(records) or bwd != active or active == 0:
        raise AssertionError('CSC training launched K1 %d times and K3 %d '
                             'times in %d steps with %d active seeds' % (
                                 fwd, bwd, len(records), active))
    log_steps('CSC training (2048 padded RoIs, 2 active seeds a step)',
              records)
    log('CSC training: loss_cls_pos %s, loss_cls_neg %s, K1 launches %d, K3 '
        'launches %d = active seeds' % (
            ['%.4g' % r['loss_cls_pos'] for r in records],
            ['%.4g' % r['loss_cls_neg'] for r in records], fwd, bwd))

    # a step past WSL.CSC_MAX_ITER is plain CE: no seed, no K3
    late = int(cfg.WSL.CSC_MAX_ITER)
    k3 = rp.roi_pool_backward_cuda.launches
    _, _, late_records = train_model(roidb, max_iters=late + 1,
                                     start_iter=late)
    if rp.roi_pool_backward_cuda.launches != k3:
        raise AssertionError('a step past CSC_MAX_ITER launched K3')
    if abs(late_records[0]['loss_cls_neg']) > 1e-6:
        raise AssertionError('loss_cls_neg %r past CSC_MAX_ITER' %
                             late_records[0]['loss_cls_neg'])
    log('CSC past CSC_MAX_ITER (iter %d): no K3 launch, loss_cls_neg %.2g'
        % (late, late_records[0]['loss_cls_neg']))

    # the trained state, one image: the kernels against the plain pool
    batch = device_batch(model, build_minibatch(
        roidb, 0, np.random.RandomState(5)))
    k3 = rp.roi_pool_backward_cuda.launches
    maps_k, keep_k, w_k = csc_maps_and_weights(model, batch, 9)
    if rp.roi_pool_backward_cuda.launches != k3 + 2 or not keep_k.any():
        raise AssertionError('expected 2 K3 launches and a kept map, got '
                             'keep %s' % keep_k.tolist())

    # the plain run finds the first max cells from the map itself
    def plain_pool(feat, rois, *args, argmax=False):
        out = rp.roi_pool_reference(feat, rois, *args)
        if not argmax:
            return out
        return out, rp.roi_pool_argmax_reference(feat, rois, *args)

    kernels = rp.roi_pool_cuda, rp.roi_pool_backward_cuda
    k1 = rp.roi_pool_cuda.launches
    rp.roi_pool_cuda = plain_pool
    rp.roi_pool_backward_cuda = (
        lambda *a: rp.roi_pool_scatter_reference(*a))
    try:
        maps_p, keep_p, w_p = csc_maps_and_weights(model, batch, 9)
    finally:
        rp.roi_pool_cuda, rp.roi_pool_backward_cuda = kernels
    if kernels[0].launches != k1 or kernels[1].launches != k3 + 2:
        raise AssertionError('the plain run launched a kernel')
    thr = spec.csc_fg_threshold
    binary_share = ((maps_k >= thr) != (maps_p >= thr)).float().mean().item()
    weight_share = ((w_k - w_p).abs() > 0.05).float().mean().item()
    log('CSC, kernels against the plain pool forward and backward (image 0, '
        'dropout seed 9): '
        'maps max abs diff %.3g, binarised cells that differ %.3g (limit '
        '%.3g), weights max abs diff %.3g, weights beyond 0.05 %.3g (limit '
        '%.3g), maps kept %s, foreground share %.3f, weights not 1: %.3f, '
        'least weight %.3f' % (
            (maps_k - maps_p).abs().max().item(), binary_share,
            CSC_MAP_TOL['binary_share'], (w_k - w_p).abs().max().item(),
            weight_share, CSC_MAP_TOL['weight_share'], keep_k.tolist(),
            (maps_k[:2] >= thr).float().mean().item(),
            (w_k != 1).float().mean().item(), w_k.min().item()))
    if (keep_k.tolist() != keep_p.tolist()
            or binary_share > CSC_MAP_TOL['binary_share']
            or weight_share > CSC_MAP_TOL['weight_share']):
        raise AssertionError('CSC weights differ between the kernels and '
                             'the plain pool')

    # at the configured tau only a labelled class the model scores at tau
    # or more is a seed: label the untrained model's highest and lowest
    # class
    cfg.WSL.CPG_TAU = tau
    strict = initialize_model_from_cfg()
    scores = image_scores(strict, batch)
    labelled = [scores.argmax().item(), scores.argmin().item()]
    labels = torch.zeros_like(batch['labels_oh'])
    labels[0, labelled] = 1.0
    expected = sum(scores[c].item() >= tau for c in labelled)
    k3 = rp.roi_pool_backward_cuda.launches
    strict.forward_cpg_maps(dict(batch, labels_oh=labels))
    ran = rp.roi_pool_backward_cuda.launches - k3
    log('CSC at WSL.CPG_TAU %s: untrained scores of the labelled classes '
        '%s, %d of 2 seeds active, %d K3 launches' % (
            tau, ['%.3g' % scores[c].item() for c in labelled], expected,
            ran))
    if ran != expected or expected == 2:
        raise AssertionError('%d K3 launches for %d seeds at or above '
                             'WSL.CPG_TAU (of 2 labelled)' % (ran, expected))
    if '--profile' in sys.argv:
        profile_train_step('CSC', model, opt_state, roidb)
    return fwd, bwd


VOC_CLASSES = ['aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus', 'car',
               'cat', 'chair', 'cow', 'diningtable', 'dog', 'horse',
               'motorbike', 'person', 'pottedplant', 'sheep', 'sofa', 'train',
               'tvmonitor']
SYNTHETIC_DATASET = 'synthetic_voc_2007_test'


def write_voc_dataset(root, pixel_means):
    """A synthetic VOC2007-test-style dataset under ``root``, from a seed:
    COCO-json annotations, the devkit's XML annotations and image-set file,
    and a proposal pkl with ~2000 boxes an image (sides above the roidb's
    20-pixel floor). Two proposals of each image are its objects. Registers
    it in the catalog. Returns ({image id: pixels}, proposal file): no
    image file is written, the pixels are handed over as arrays."""
    from nafwebsod_torch.data import catalog
    rng = np.random.RandomState(11)
    entries = synthetic_roidb(4, pixel_means, min_side=22)
    voc_root = os.path.join(root, 'devkit', 'VOC2007')
    os.makedirs(os.path.join(voc_root, 'Annotations'))
    os.makedirs(os.path.join(voc_root, 'ImageSets', 'Main'))
    images, annotations, stems, pixels = [], [], [], {}
    for i, entry in enumerate(entries):
        image_id = i + 1
        stem = '%06d' % image_id
        h, w = entry['image'].shape[:2]
        images.append({'id': image_id, 'file_name': stem + '.jpg',
                       'width': w, 'height': h})
        pixels[image_id] = entry['image']
        stems.append(stem)
        xml = ['<annotation>']
        for row in rng.choice(np.arange(1, NUM_PROPOSALS // 10), 2,
                              replace=False):
            x1, y1, x2, y2 = (int(v) for v in entry['boxes'][row])
            cls = int(rng.randint(len(VOC_CLASSES)))
            annotations.append({
                'id': len(annotations) + 1, 'image_id': image_id,
                'category_id': cls + 1, 'iscrowd': 0,
                'bbox': [x1, y1, x2 - x1 + 1, y2 - y1 + 1],
                'area': (x2 - x1 + 1) * (y2 - y1 + 1)})
            xml.append(          # the devkit's boxes are 1-based
                '<object><name>%s</name><pose>Unspecified</pose>'
                '<truncated>0</truncated><difficult>0</difficult><bndbox>'
                '<xmin>%d</xmin><ymin>%d</ymin><xmax>%d</xmax><ymax>%d</ymax>'
                '</bndbox></object>' % (VOC_CLASSES[cls], x1 + 1, y1 + 1,
                                        x2 + 1, y2 + 1))
        xml.append('</annotation>')
        with open(os.path.join(voc_root, 'Annotations', stem + '.xml'),
                  'w') as f:
            f.write(''.join(xml))
    with open(os.path.join(voc_root, 'ImageSets', 'Main', 'test.txt'),
              'w') as f:
        f.write('\n'.join(stems) + '\n')
    ann_file = os.path.join(root, 'annotations.json')
    with open(ann_file, 'w') as f:
        json.dump({'images': images, 'annotations': annotations,
                   'categories': [{'id': i + 1, 'name': name}
                                  for i, name in enumerate(VOC_CLASSES)]}, f)
    proposal_file = os.path.join(root, 'proposals.pkl')
    with open(proposal_file, 'wb') as f:
        pickle.dump({'boxes': [e['boxes'] for e in entries],
                     'scores': [e['obn_scores'] for e in entries],
                     'ids': [im['id'] for im in images]}, f, 2)
    catalog.register_dataset(SYNTHETIC_DATASET, os.path.join(root, 'images'),
                             ann_file, os.path.join(root, 'devkit'))
    return pixels, proposal_file


def phase_context_inference():
    """Phase 8. Returns (RoIPoolF launches, RoILoopPool launches) of the
    counted run."""
    from nafwebsod_torch.core.config import (CONTEXT, cfg, get_output_dir,
                                             merge_cfg_from_cfg, reset_cfg)
    from nafwebsod_torch.data import task_evaluation
    from nafwebsod_torch.engine import test_engine
    from nafwebsod_torch.ops import context as ctx
    from nafwebsod_torch.utils.io import load_object

    reset_cfg()
    merge_cfg_from_cfg(CONTEXT)
    with tempfile.TemporaryDirectory() as root:
        pixels, proposal_file = write_voc_dataset(root, cfg.PIXEL_MEANS)
        cfg.TEST.DATASETS = (SYNTHETIC_DATASET,)
        cfg.TEST.PROPOSAL_FILES = (proposal_file,)
        cfg.OUTPUT_DIR = os.path.join(root, 'out')
        det_file = os.path.join(
            get_output_dir((SYNTHETIC_DATASET,), training=False),
            'detections.pkl')

        # as a user calls it: the model built from the cfg on the card (also
        # the warm-up of this phase)
        first = test_engine.run_inference(images=pixels)
        model = test_engine.initialize_model_from_cfg()
        spec = model.spec
        assert spec.is_context and spec.compute_dtype == 'bfloat16'
        assert spec.hidden_dim == 4096 and spec.num_classes == 21
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.time()
        results = test_engine.run_inference(model=model, images=pixels)
        torch.cuda.synchronize()
        wall = time.time() - t0
        fwd, bwd, ring, align = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        n = len(pixels)
        if (fwd, bwd, ring, align) != (n, 0, 2 * n, 0):
            raise AssertionError('context inference over %d images launched '
                                 'K1 %d times, K3 %d times, K2 %d times, K4 '
                                 '%d times' % (n, fwd, bwd, ring, align))
        saved = load_object(det_file)
        if saved['image_ids'] != sorted(pixels):
            raise AssertionError('detections.pkl image_ids %s' %
                                 saved['image_ids'])
        all_boxes = saved['all_boxes']
        check_detections(all_boxes, n, int(cfg.TEST.DETECTIONS_PER_IM))
        res = results[SYNTHETIC_DATASET]
        for key in ('mAP', 'mean_corloc'):
            if not (np.isfinite(res[key]) and 0.0 <= res[key] <= 1.0):
                raise AssertionError('%s = %r' % (key, res[key]))
        if sorted(res['ap']) != sorted(VOC_CLASSES):
            raise AssertionError('AP classes %s' % sorted(res['ap']))
        if first != results:
            raise AssertionError('two runs from the same seed disagree: '
                                 '%r != %r' % (first, results))
        roidb, dataset = test_engine.get_roidb_and_dataset(
            SYNTHETIC_DATASET, proposal_file)
        # the evaluator on this dataset: the ground truth as detections
        # scores 1 in every class that has an object
        truth = test_engine.empty_results(21, n)
        present = set()
        for i, entry in enumerate(roidb):
            for j in np.unique(entry['gt_classes'][entry['gt_classes'] > 0]):
                gt = entry['boxes'][entry['gt_classes'] == j]
                truth[j][i] = np.hstack(
                    [gt, np.ones((len(gt), 1))]).astype(np.float32)
                present.add(VOC_CLASSES[j - 1])
        ideal = task_evaluation.evaluate_all(
            dataset, truth, None, None, os.path.join(root, 'out', 'truth'),
            image_ids=saved['image_ids'])[SYNTHETIC_DATASET]
        for name in VOC_CLASSES:
            want = float(name in present)
            if ideal['ap'][name] != want or ideal['corloc'][name] != want:
                raise AssertionError(
                    'ground truth as detections: %s AP %r CorLoc %r' % (
                        name, ideal['ap'][name], ideal['corloc'][name]))
        log('context inference: %d images through run_inference and the VOC '
            'evaluator in %.1f ms (host clock, evaluation included), '
            'proposals per image %s, peak device memory %.0f MiB, '
            'detections per image %s, mAP %.4f, mean CorLoc %.4f (the '
            'ground truth as detections: AP and CorLoc 1 in its %d '
            'classes), K1 launches %d, K2 launches %d' % (
                n, wall * 1e3,
                [int((e['gt_classes'] == 0).sum()) for e in roidb], peak,
                [sum(len(all_boxes[j][i]) for j in range(1, 21))
                 for i in range(n)], res['mAP'], res['mean_corloc'],
                len(present), fwd, ring))
        for entry in roidb:
            entry['image'] = pixels[entry['id']]
        torch.cuda.synchronize()
        t0 = time.time()
        test_engine.test_net(model, roidb)
        torch.cuda.synchronize()
        log('context inference: test_net alone %.2f ms/image (host clock)' %
            ((time.time() - t0) / n * 1e3))

        # the same run with the ring pool forced to the plain version
        kernel = ctx.roi_loop_pool_cuda
        ctx.roi_loop_pool_cuda = lambda *a: ctx.roi_loop_pool_reference(*a)
        try:
            test_engine.run_inference(model=model, images=pixels)
        finally:
            ctx.roi_loop_pool_cuda = kernel
        if kernel.launches != 2 * ring:    # test_net alone ran once more
            raise AssertionError('the plain run launched the kernel')
        plain_boxes = load_object(det_file)['all_boxes']
        for j in range(1, 21):
            for i in range(n):
                if not np.array_equal(all_boxes[j][i], plain_boxes[j][i]):
                    raise AssertionError('class %d image %d: kernel and '
                                         'plain ring pool differ' % (j, i))
        log('plain ring pool on the card: identical detections')
        if '--profile' in sys.argv:
            profile_image(model, roidb[0])
    return fwd, ring


def phase_train_context():
    """Phase 9. Returns (RoIPoolF launches, RoILoopPool launches)."""
    from nafwebsod_torch.core.config import (CONTEXT, cfg,
                                             merge_cfg_from_cfg, reset_cfg)
    from nafwebsod_torch.engine.test_engine import initialize_model_from_cfg
    from nafwebsod_torch.engine.train import train_model

    reset_cfg()
    merge_cfg_from_cfg(CONTEXT)
    cfg.SOLVER.BASE_LR = TRAIN_BASE_LR
    roidb = train_roidb(cfg.PIXEL_MEANS)
    before = {k: v.clone() for k, v in
              initialize_model_from_cfg().state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    model, opt_state, records = train_model(roidb, max_iters=3)
    torch.cuda.synchronize()
    fwd, bwd, ring, align = read_counts()
    spec = model.spec
    assert spec.is_context and spec.compute_dtype == 'bfloat16'
    assert spec.hidden_dim == 4096 and spec.freeze_conv_body
    for r in records:
        for key in ('loss', 'loss_cls'):
            if not np.isfinite(r[key]):
                raise AssertionError('iter %d: %s = %r' % (
                    r['iter'], key, r[key]))
    # fc8d = FC(frame) - FC(context) through one layer: its bias cancels,
    # gets a zero gradient, and stays at its initial zeros
    check_leaves_moved(model, before, unmoved=('head.fc8d_frame.bias',))
    if (fwd, bwd, ring, align) != (len(records), 0, 2 * len(records), 0):
        raise AssertionError('context training launched K1 %d times, K3 %d '
                             'times, K2 %d times and K4 %d times in %d steps'
                             % (fwd, bwd, ring, align, len(records)))
    log_steps('context training (2048 padded RoIs, three streams)', records)
    log('context training: K1 launches %d, K2 launches %d, K3 launches %d'
        % (fwd, ring, bwd))
    if '--profile' in sys.argv:
        profile_train_step('context', model, opt_state, roidb)
    return fwd, ring


def check_segms(all_boxes, all_segms, roidb, expand):
    """One RLE per detection, each of the image's size; each decoded mask
    lies inside its box (expanded about its centre by ``expand`` and
    truncated to integers, as the paste does) and inside the image.
    Returns (number of masks, share of them that are not empty)."""
    from nafwebsod_torch.ops import boxes as box_utils
    from nafwebsod_torch.utils.segms import rle_to_mask
    n_masks = filled = 0
    for i, entry in enumerate(roidb):
        h, w = entry['image'].shape[:2]
        for j in range(1, 21):
            dets = np.asarray(all_boxes[j][i]).reshape(-1, 5)
            segms = all_segms[j][i]
            if len(segms) != len(dets):
                raise AssertionError('image %d class %d: %d masks for %d '
                                     'detections' % (i, j, len(segms),
                                                     len(dets)))
            if not len(dets):
                continue
            boxes = box_utils.expand_boxes(dets[:, :4], expand).astype(
                np.int32)
            for rle, box in zip(segms, boxes):
                mask = rle_to_mask(rle)
                if rle['size'] != [h, w] or mask.shape != (h, w):
                    raise AssertionError('mask of size %s in a %dx%d image'
                                         % (rle['size'], h, w))
                ys, xs = np.nonzero(mask)
                n_masks += 1
                if not len(ys):
                    continue
                filled += 1
                if (xs.min() < box[0] or xs.max() > box[2]
                        or ys.min() < box[1] or ys.max() > box[3]):
                    raise AssertionError(
                        'image %d class %d: a mask leaves its box %s' % (
                            i, j, box.tolist()))
    if filled == 0:     # the checks above would have held nothing
        raise AssertionError('%d masks, none with a pixel' % n_masks)
    return n_masks, filled / n_masks


def phase_seg_fcn_inference():
    """Phase 10, inference. Returns (RoIPoolF launches, RoIAlign
    launches) of the counted run."""
    from nafwebsod_torch.core.config import (SEG_FCN, cfg,
                                             merge_cfg_from_cfg, reset_cfg)
    from nafwebsod_torch.engine.test_engine import (
        initialize_model_from_cfg, test_net)
    from nafwebsod_torch.ops import roi_pool as rp
    from nafwebsod_torch.utils.io import load_object

    reset_cfg()
    merge_cfg_from_cfg(SEG_FCN)
    model = initialize_model_from_cfg()
    spec = model.spec
    assert spec.mask_on and spec.mask_head == 'fcn'
    assert (spec.mask_resolution, spec.mask_dim_reduced) == (14, 256)
    assert spec.compute_dtype == 'bfloat16' and spec.hidden_dim == 4096
    roidb = synthetic_roidb(5, cfg.PIXEL_MEANS)
    n = len(roidb)
    test_net(model, roidb[:1])                   # warm-up image
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.time()
        all_boxes, all_segms, _ = test_net(model, roidb, out_dir)
        torch.cuda.synchronize()
        wall = time.time() - t0
        saved = load_object(os.path.join(out_dir, 'detections.pkl'))
    fwd, bwd, ring, align = read_counts()
    if (fwd, bwd, ring, align) != (n, 0, 0, n):
        raise AssertionError('SEG_FCN inference over %d images launched K1 '
                             '%d times, K3 %d times, K2 %d times, K4 %d '
                             'times' % (n, fwd, bwd, ring, align))
    check_detections(all_boxes, n, int(cfg.TEST.DETECTIONS_PER_IM))
    m = 2 * spec.mask_resolution
    n_masks, filled = check_segms(all_boxes, all_segms, roidb, (m + 2.0) / m)
    if saved['all_segms'] != all_segms:
        raise AssertionError('detections.pkl does not hold the masks')
    log('SEG_FCN inference: %d images, %.2f ms/image (host clock, after a '
        'warm-up image, masks and RLEs included), peak device memory %.0f '
        'MiB, %d masks (one per detection, %.2f of them not empty), each '
        'inside its expanded box and its image, K1 launches %d, K4 launches '
        '%d' % (n, wall / n * 1e3,
                torch.cuda.max_memory_allocated() / 2 ** 20, n_masks, filled,
                fwd, align))

    # the same images with RoIAlign forced to its plain version
    kernel = rp.roi_align_cuda
    rp.roi_align_cuda = lambda *a: rp.roi_align_reference(*a)
    try:
        plain_boxes, plain_segms, _ = test_net(model, roidb)
    finally:
        rp.roi_align_cuda = kernel
    if kernel.launches != align:
        raise AssertionError('the plain run launched the kernel')
    if plain_segms != all_segms:
        raise AssertionError('kernel and plain RoIAlign give other masks')
    log('plain RoIAlign on the card: identical masks')
    if '--profile' in sys.argv:
        profile_image(model, roidb[0])
    return fwd, align


def check_momentum(opt_state, names):
    """The gradient reached each of the named leaves: a finite momentum
    buffer that is not all zero."""
    for name in names:
        v = opt_state['momentum'][name]
        if not torch.isfinite(v).all() or not v.any():
            raise AssertionError('momentum of %s is zero or not finite'
                                 % name)


def phase_train_seg_fcn():
    """Phase 10, training. Returns (RoIPoolF launches, RoIAlign
    launches)."""
    from nafwebsod_torch.core.config import (SEG_FCN, cfg,
                                             merge_cfg_from_cfg, reset_cfg)
    from nafwebsod_torch.engine.test_engine import initialize_model_from_cfg
    from nafwebsod_torch.engine.train import train_model
    from nafwebsod_torch.utils.bridge import blob_names

    reset_cfg()
    merge_cfg_from_cfg(SEG_FCN)
    cfg.SOLVER.BASE_LR = TRAIN_BASE_LR
    roidb = train_roidb(cfg.PIXEL_MEANS)
    before = {k: v.clone() for k, v in
              initialize_model_from_cfg().state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    model, opt_state, records = train_model(roidb, max_iters=3)
    torch.cuda.synchronize()
    fwd, bwd, ring, align = read_counts()
    spec = model.spec
    assert spec.mask_on and spec.mask_head == 'fcn' and spec.freeze_conv_body
    assert spec.compute_dtype == 'bfloat16' and spec.hidden_dim == 4096
    for r in records:
        for key in ('loss', 'loss_cls', 'mask_loss_cls'):
            if not np.isfinite(r[key]):
                raise AssertionError('iter %d: %s = %r' % (
                    r['iter'], key, r[key]))
        if r['mask_loss_cls'] <= 0:
            raise AssertionError('mask_loss_cls %r' % r['mask_loss_cls'])
    # The mask tower starts at weights of std 0.001, and its loss is a mean
    # over 2048 RoIs and 20 classes: at this learning rate a weight's step
    # is below float32's resolution of the weight, so its value may stay.
    # Its gradient must have arrived all the same: every mask leaf's
    # momentum is non-zero, and the biases (which start at 0) moved.
    mask_weights = tuple(k for k in before if k.startswith('mask_head.')
                         and k.endswith('.weight'))
    names = blob_names(model)
    check_momentum(opt_state, [names[k] for k in before
                               if k.startswith('mask_head.')])
    moved = check_leaves_moved(model, before, may_stay=mask_weights)
    if (fwd, bwd, ring, align) != (len(records), 0, 0, len(records)):
        raise AssertionError('SEG_FCN training launched K1 %d times, K3 %d '
                             'times, K2 %d times and K4 %d times in %d steps'
                             % (fwd, bwd, ring, align, len(records)))
    log_steps('SEG_FCN training (2048 padded RoIs, float32 mask tower)',
              records)
    log('SEG_FCN training: mask_loss_cls %s, every mask leaf has momentum, '
        'mask weights that moved at this learning rate: %s, K1 launches %d, '
        'K4 launches %d' % (['%.4g' % r['mask_loss_cls'] for r in records],
                            moved, fwd, align))
    if '--profile' in sys.argv:
        profile_train_step('SEG_FCN', model, opt_state, roidb)
    return fwd, align


def phase_align_box_transform():
    """Phase 11. Returns the RoIAlign launches of the counted forward."""
    from nafwebsod_torch.core.config import (CSC, cfg, merge_cfg_from_cfg,
                                             reset_cfg)
    from nafwebsod_torch.engine import test as infer
    from nafwebsod_torch.engine.test_engine import initialize_model_from_cfg
    from nafwebsod_torch.ops import roi_pool as rp

    reset_cfg()
    merge_cfg_from_cfg(CSC)       # the plain 2fc head, without CPG and CSC
    cfg.WSL.CPG = cfg.WSL.CSC = False
    cfg.FAST_RCNN.ROI_XFORM_METHOD = 'RoIAlign'
    model = initialize_model_from_cfg()
    assert model.spec.roi_xform_method == 'RoIAlign'
    assert model.spec.roi_sampling_ratio == 2
    e = synthetic_roidb(6, cfg.PIXEL_MEANS)[0]
    reset_counts()
    scores, _, _ = infer.im_detect_bbox(model, e['image'], cfg.TEST.SCALE,
                                        cfg.TEST.MAX_SIZE, e['boxes'],
                                        e['obn_scores'])
    counts = read_counts()
    if counts != (0, 0, 0, 1):
        raise AssertionError('RoIAlign box transform: launches %s' %
                             (counts,))
    if scores.shape != (NUM_PROPOSALS, 21) or not np.isfinite(scores).all():
        raise AssertionError('bad scores %s' % (scores.shape,))
    kernel = rp.roi_align_cuda
    rp.roi_align_cuda = lambda *a: rp.roi_align_reference(*a)
    try:
        plain, _, _ = infer.im_detect_bbox(
            model, e['image'], cfg.TEST.SCALE, cfg.TEST.MAX_SIZE, e['boxes'],
            e['obn_scores'])
    finally:
        rp.roi_align_cuda = kernel
    if not np.array_equal(scores, plain):
        raise AssertionError('RoIAlign box transform: kernel and plain '
                             'scores differ by %g' % np.abs(scores
                                                           - plain).max())
    log('RoIAlign as the box transform: %d proposals, scores finite and '
        'equal to the plain-version rerun, K4 launches %d' % (
            len(scores), counts[3]))
    return counts[3]


def phase_seg_deeplab():
    """Phase 12. Returns (RoIPoolF launches, RoIPoolF backward launches)
    of inference plus training."""
    from nafwebsod_torch.core.config import (SEG, cfg, merge_cfg_from_cfg,
                                             reset_cfg)
    from nafwebsod_torch.engine.test_engine import (
        initialize_model_from_cfg, test_net)
    from nafwebsod_torch.engine.train import train_model

    reset_cfg()
    merge_cfg_from_cfg(SEG)
    model = initialize_model_from_cfg()
    spec = model.spec
    assert spec.is_deeplab and spec.cpg and not spec.csc
    assert spec.compute_dtype == 'bfloat16' and spec.hidden_dim == 4096
    roidb = synthetic_roidb(7, cfg.PIXEL_MEANS)[:2]
    test_net(model, roidb[:1])                   # warm-up image
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    all_boxes, all_segms, _ = test_net(model, roidb)
    torch.cuda.synchronize()
    wall = time.time() - t0
    infer_counts = read_counts()
    if infer_counts != (len(roidb), 0, 0, 0):
        raise AssertionError('SEG inference: launches %s' % (infer_counts,))
    n_masks, filled = check_segms(all_boxes, all_segms, roidb, 1.0)
    log('SEG (deeplab) inference: %d images, %.2f ms/image (host clock, '
        'after a warm-up image), peak device memory %.0f MiB, %d masks '
        '(%.2f of them not empty), each inside its box and its image, K1 '
        'launches %d' % (
            len(roidb), wall / len(roidb) * 1e3,
            torch.cuda.max_memory_allocated() / 2 ** 20, n_masks, filled,
            infer_counts[0]))
    del model

    cfg.SOLVER.BASE_LR = TRAIN_BASE_LR
    tau = cfg.WSL.CPG_TAU
    cfg.WSL.CPG_TAU = 0.0
    log('SEG training: WSL.CPG_TAU lowered from %s to 0.0 -- both labelled '
        'classes of an image are CPG seeds' % tau)
    roidb = train_roidb(cfg.PIXEL_MEANS)
    before = label_with_top_classes('SEG', roidb)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    model, opt_state, records = train_model(roidb, max_iters=3)
    torch.cuda.synchronize()
    fwd, bwd, ring, align = read_counts()
    for r in records:
        for key in ('loss', 'loss_cls', 'mask_seed_loss',
                    'mask_constraint_loss'):
            if not np.isfinite(r[key]):
                raise AssertionError('iter %d: %s = %r' % (
                    r['iter'], key, r[key]))
    check_leaves_moved(model, before)
    seeds = 2 * len(records)
    if (fwd, bwd, ring, align) != (len(records), seeds, 0, 0):
        raise AssertionError('SEG training launched K1 %d times, K3 %d '
                             'times, K2 %d times and K4 %d times in %d steps '
                             'with %d seeds' % (fwd, bwd, ring, align,
                                                len(records), seeds))
    log_steps('SEG (deeplab) training (2 CPG seeds a step, ASPP head, dense '
              'CRF on the mask grid)', records)
    log('SEG training: mask_seed_loss %s, mask_constraint_loss %s, K1 '
        'launches %d, K3 launches %d = seeds' % (
            ['%.4g' % r['mask_seed_loss'] for r in records],
            ['%.4g' % r['mask_constraint_loss'] for r in records], fwd, bwd))
    return infer_counts[0] + fwd, bwd


def host_ms(fn, reps=10):
    """(min, median, max) host-clock ms of fn() ending in a synchronize,
    after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
    return min(times), statistics.median(times), max(times)


def profile_image(model, entry):
    """Where one image's time goes: host-clock stage times, and
    torch.profiler's device time by kernel with the busy share of the
    window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from nafwebsod_torch.core.config import cfg
    from nafwebsod_torch.data.minibatch import (pad_image_to_bucket,
                                                prep_im_for_blob)
    from nafwebsod_torch.engine import test as infer
    from nafwebsod_torch.engine.test_engine import test_net

    im, boxes, obn = entry['image'], entry['boxes'], entry['obn_scores']
    dev = model.device

    def prep():
        blob, scale = prep_im_for_blob(im, cfg.PIXEL_MEANS, cfg.TEST.SCALE,
                                       cfg.TEST.MAX_SIZE, cfg.PIXEL_STDS,
                                       device=dev)
        rois, o, unique, _ = infer._dedup_scaled_rois(boxes, obn, scale)
        return (pad_image_to_bucket(blob, cfg.TPU.SIZE_BUCKET_MULTIPLE)[None],
                torch.from_numpy(rois).to(dev), torch.from_numpy(o).to(dev),
                unique)

    im_in, rois, o, unique = prep()
    scores = model.forward_test(im_in, rois, o)['scores'].float()
    tiled = torch.as_tensor(unique.astype(np.float32), device=dev)[:, None]
    tiled = tiled.expand(-1, scores.shape[1], 4)
    stages = {
        'host prep + copy': host_ms(prep),
        'body': host_ms(lambda: model.body_forward(im_in)),
        'forward_test': host_ms(lambda: model.forward_test(im_in, rois, o)),
        'nms + cap': host_ms(lambda: infer._nms_limit(scores, tiled, dev)),
        'im_detect_all': host_ms(lambda: infer.im_detect_all(
            model, im, boxes, obn)),
    }
    log('stages (host clock ms, min / median / max of 10): ' + ', '.join(
        '%s %.3f / %.3f / %.3f' % ((k,) + v) for k, v in stages.items()))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        test_net(model, [entry])
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    # kernels only: a CPU op's self device time repeats its kernels' time
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU), reverse=True)
    busy = sum(r[0] for r in rows)
    log('profile: host window %.1f us, kernel time %.1f us (%.1f%% busy), '
        '%d kernel launches; kernels by device time:' % (
            wall_us, busy, 100.0 * busy / wall_us, sum(r[1] for r in rows)))
    for row in rows:
        log(('  %10.1f us %5d x  %s' % row)[:150])


def profile_train_step(name, model, opt_state, roidb):
    """Where one train step's time goes: host-clock stage times (each
    ending in a synchronize), and torch.profiler's device time by kernel
    with the busy share of one whole step. The steps it takes move
    ``model`` and ``opt_state`` on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from nafwebsod_torch.core.config import cfg
    from nafwebsod_torch.engine.train import build_minibatch, create_solver
    from nafwebsod_torch.ops import cpg as cpg_ops
    from nafwebsod_torch.parallel import train_step as ts
    from nafwebsod_torch.solver import sgd
    from nafwebsod_torch.utils.bridge import named_blobs

    hp, mults, _ = create_solver(model)
    rng = np.random.RandomState(7)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(7)
    lr = np.float32(cfg.SOLVER.BASE_LR)

    def minibatch():
        return device_batch(model, build_minibatch(roidb, 0, rng))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.time() - t0) * 1e3

    cpg_ms = []
    cpg_maps = cpg_ops.cpg_maps

    def timed_cpg_maps(*args, **kwargs):
        out, ms = timed(lambda: cpg_maps(*args, **kwargs))
        cpg_ms.append(ms)
        return out

    params = named_blobs(model)
    names = [n for n in params if mults[n] != (0.0, 0.0)]
    rows = []
    cpg_ops.cpg_maps = timed_cpg_maps
    try:
        for _ in range(4):          # the first repetition is the warm-up
            del cpg_ms[:]
            batch, t_data = timed(minibatch)
            (total, _), t_fwd = timed(
                lambda: model.forward_train(batch, gen))
            grads, t_bwd = timed(lambda: torch.autograd.grad(
                total, [params[n] for n in names]))
            _, t_upd = timed(lambda: sgd.update(
                params, dict(zip(names, grads)), opt_state, lr, hp, mults))
            rows.append((t_data, t_fwd - sum(cpg_ms), sum(cpg_ms), t_bwd,
                         t_upd, tuple(batch['image'].shape[1:3])))
    finally:
        cpg_ops.cpg_maps = cpg_maps
    for row in rows[1:]:
        log('%s step stages (host clock ms): minibatch + upload %.1f, '
            'forward %.1f, CPG seeds %.1f, backward %.1f, update %.1f; '
            'image %s' % ((name,) + row))

    batch = minibatch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        ts.train_step(model, opt_state, batch, lr, gen, hp=hp, mults=mults)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    kernels = sorted(((e.self_device_time_total, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type != DeviceType.CPU), reverse=True)
    busy = sum(k[0] for k in kernels)
    log('%s step profile (image %s): host window %.1f us, kernel time %.1f '
        'us (%.1f%% busy), %d kernel launches; top kernels by device time:'
        % (name, tuple(batch['image'].shape[1:3]), wall_us, busy,
           100.0 * busy / wall_us, sum(k[1] for k in kernels)))
    for k in kernels[:14]:
        log(('  %10.1f us %5d x  %s' % k)[:150])
    # the port's own kernels, wherever they rank
    log('%s step: the port\'s kernels: %s' % (name, '; '.join(
        '%s %.1f us in %d launches, %.2f%% of the kernel time' % (
            key.split('::', 1)[1].split('(')[0], us, n, 100.0 * us / busy)
        for us, n, key in kernels if '(anonymous namespace)::roi_' in key)))


def main():
    failed = None
    smi = None
    kernels = []
    try:
        smi = phase_device()
        phase_build()
        k1 = phase_k1()
        k2 = phase_k2()
        k3 = phase_k3()
        k4 = phase_k4()
        infer_fwd = phase_slice()
        train_fwd = phase_train_flagship()
        csc_fwd, k3['launches'] = phase_train_csc()
        ctx_infer_fwd, ctx_infer_ring = phase_context_inference()
        ctx_train_fwd, ctx_train_ring = phase_train_context()
        fcn_infer_fwd, fcn_infer_align = phase_seg_fcn_inference()
        fcn_train_fwd, fcn_train_align = phase_train_seg_fcn()
        box_align = phase_align_box_transform()
        deeplab_fwd, deeplab_bwd = phase_seg_deeplab()
        # each path was driven with the counts set to 0 just before it
        k1['launches'] = (infer_fwd + train_fwd + csc_fwd + ctx_infer_fwd
                          + ctx_train_fwd + fcn_infer_fwd + fcn_train_fwd
                          + deeplab_fwd)
        k2['launches'] = ctx_infer_ring + ctx_train_ring
        csc_bwd = k3['launches']
        k3['launches'] = csc_bwd + deeplab_bwd
        k4['launches'] = fcn_infer_align + fcn_train_align + box_align
        log('K1 launches that wrote the first-max index, by counted run: '
            '%s (%d; every K1 launch of the runs with K3 launches, none of '
            'the others)' % (INDEX_LAUNCHES, sum(INDEX_LAUNCHES)))
        log('K1 launches by path: flagship inference %d, flagship training '
            '%d, CSC training %d, context inference %d, context training '
            '%d, SEG_FCN inference %d, SEG_FCN training %d, SEG inference '
            'and training %d; K2 launches: context inference %d, context '
            'training %d; K3 launches: CSC training %d, SEG training %d; K4 '
            'launches: SEG_FCN inference %d, SEG_FCN training %d, box '
            'transform %d' % (
                infer_fwd, train_fwd, csc_fwd, ctx_infer_fwd, ctx_train_fwd,
                fcn_infer_fwd, fcn_train_fwd, deeplab_fwd, ctx_infer_ring,
                ctx_train_ring, csc_bwd, deeplab_bwd, fcn_infer_align,
                fcn_train_align, box_align))
        kernels.extend([k1, k2, k3, k4])
    except Exception as exc:  # report the phase that failed, exit non-zero
        import traceback
        traceback.print_exc()
        failed = repr(exc)
    if failed is not None:
        log('FAILED:', failed)
        sys.exit(1)
    log(json.dumps({'kernels': kernels}))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
