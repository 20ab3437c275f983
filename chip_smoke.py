"""Smoke run of the PyTorch port on one NVIDIA GPU (sm_90a, an H100).

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:
  1. device: a CUDA card, its name and power limit, TF32 off;
  2. build every CUDA kernel of the path from the sources in this checkout;
  3. each kernel against its plain PyTorch version on the card at the main
     path's shapes (RoIPoolF: an (87, 119, 512) map -- a 375x500 image at
     TEST.SCALE 688 -- and 2048 RoIs with edge cases), bitwise in float32
     and bfloat16, with its time, the plain version's time and its bound;
  4. the flagship inference path at full width (dilated VGG16-C5, two
     4096-wide towers, 21 classes, bfloat16, random weights from a seed)
     through test_net -> im_detect_all over three synthetic images with
     ~2000 proposals each, counting kernel launches;
  5. the same images with the pool forced to its plain version: the
     detections must be identical to phase 4.
The last lines are the kernel table (JSON), the card's
``nvidia-smi --query-gpu=name,power.limit`` line, and the result (JSON).
Imports nothing of JAX. Needs one card; exits non-zero without one.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

MEM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
IMAGE_SIZES = [(375, 500), (500, 333), (480, 640)]
NUM_PROPOSALS = 2000


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
    reports = _build.build(['roi_pool'])
    for name, report in reports.items():
        log('nvcc', name, ':', report.strip().replace('\n', ' | '))
    _build.load('roi_pool')
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


def k1_bound_ms(feat, rois, out):
    """The larger of bytes / memory rate (map read once, RoIs read once,
    outputs written once) and this run's max operations (one per bin cell
    and channel) / the float32 rate."""
    from nafwebsod_torch.ops import roi_pool as rp
    nbytes = (feat.numel() * feat.element_size() + rois.numel() * 4
              + out.numel() * out.element_size())
    h, w, c = feat.shape
    q = rp._round_half_away(rois[:, 1:5].float().cpu() * 0.125).long()
    x1, y1, x2, y2 = q.unbind(1)
    hs, he = rp._bin_edges(y1, (y2 - y1 + 1).clamp(min=1), 7, h)
    ws, we = rp._bin_edges(x1, (x2 - x1 + 1).clamp(min=1), 7, w)
    cells = ((he - hs).clamp(min=0)[:, :, None] *
             (we - ws).clamp(min=0)[:, None, :]).sum().item()
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = cells * c / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ('bytes' if bytes_ms >= ops_ms
                                   else 'operations')


def phase_k1():
    from nafwebsod_torch.ops import roi_pool as rp
    rng = np.random.RandomState(0)
    rois = torch.from_numpy(k1_rois(rng, 2048, 917, 688)).cuda()
    base = torch.relu(torch.from_numpy(
        rng.randn(87, 119, 512).astype(np.float32))).cuda()
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        feat = base.to(dtype)
        got = rp.roi_pool_cuda(feat, rois)
        want = rp.roi_pool_reference(feat, rois)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError('K1 %s differs from the plain version: '
                                 'max abs err %g' % (dtype, err))
        ms = time_ms(lambda: rp.roi_pool_cuda(feat, rois), 50)
        plain_ms = time_ms(lambda: rp.roi_pool_reference(feat, rois), 3)
        bound_ms, bound_by = k1_bound_ms(feat, rois, got)
        log('K1 %s (87,119,512) R=2048: equal, kernel %.4f ms, plain %.4f '
            'ms, bound %.4f ms (%s), empty-bin share %.3f' % (
                str(dtype), ms, plain_ms, bound_ms, bound_by,
                (want == 0).all(-1).float().mean().item()))
        if dtype == torch.bfloat16:  # the flagship's compute dtype
            row = {'name': 'roi_pool_fwd', 'route': 'cuda',
                   'source': 'nafwebsod_torch/ops/csrc/roi_pool.cu',
                   'replaces':
                       'nafwebsod_tpu/ops/pallas/roi_pool_pallas.py:181',
                   'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                   'bound_ms': bound_ms, 'bound_by': bound_by,
                   # no single PyTorch call computes RoIPoolF
                   'library_ms': None}
    return row


def synthetic_roidb(seed, pixel_means):
    """Seeded uint8 BGR images of VOC-like sizes with ~2000 MCG-like
    proposals and objectness each. The pixels are 16-px blocks plus noise
    of a few units around the pixel means: the random-weight network has
    zero biases, so its logits scale with the pixel amplitude, and at the
    amplitude of a photograph both softmaxes saturate and leave a handful
    of detections per image."""
    rng = np.random.RandomState(seed)
    roidb = []
    for i, (h, w) in enumerate(IMAGE_SIZES):
        coarse = rng.uniform(-6, 6, (h // 16 + 2, w // 16 + 2, 3))
        im = np.kron(coarse, np.ones((16, 16, 1)))[:h, :w]
        im = np.clip(pixel_means.reshape(1, 1, 3) + im +
                     rng.randn(h, w, 3) * 2, 0, 255).astype(np.uint8)
        x1 = rng.uniform(0, w - 8, NUM_PROPOSALS)
        y1 = rng.uniform(0, h - 8, NUM_PROPOSALS)
        bw = np.exp(rng.uniform(np.log(8), np.log(w), NUM_PROPOSALS))
        bh = np.exp(rng.uniform(np.log(8), np.log(h), NUM_PROPOSALS))
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
    rp.roi_pool_cuda.launches = 0
    t0 = time.time()
    all_boxes = test_net(model, roidb)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = rp.roi_pool_cuda.launches
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
    rp.roi_pool_cuda = lambda *a: rp.roi_pool_reference(*a)
    try:
        plain_boxes = test_net(model, roidb)
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


def main():
    failed = None
    smi = None
    kernels = []
    try:
        smi = phase_device()
        phase_build()
        k1 = phase_k1()
        k1['launches'] = phase_slice()
        kernels.append(k1)
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
