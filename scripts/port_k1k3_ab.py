"""The RoIPoolF kernels' first designs against their redesigns, on one card
in one run.

    python3 scripts/port_k1k3_ab.py

Run it from the root of the checkout. It builds, one nvcc per source, all
started together:
  * K1, the forward: the first design (scripts/attic/roi_pool_v1.cu) and
    the package's (nafwebsod_torch/ops/csrc/roi_pool.cu), without and with
    the first-max index;
  * K3, the backward: the first design (scripts/attic/roi_pool_bwd_v1.cu,
    a rescan by one thread per channel), candidate (a), the scatter from
    the forward's saved index (the package's csrc/roi_pool_bwd.cu), and
    candidate (b), a rescan with the forward's new scan
    (scripts/attic/roi_pool_bwd_rescan.cu); and two parts of (a) alone:
    its reads of the index and g without the atomics, and its atomics
    without reading g (-DROI_POOL_BWD_PART=1 and 2);
holds every one against the plain version first (the forwards bitwise,
the backwards bitwise on integer cotangents), and then times them in turns
(old, new, new, old; K3: first design, (a), (b), (b), (a), first design),
each reading the median of 50 CUDA-event timings after a warm-up, at
chip_smoke.py phase 3's shape: an (87, 119, 512) ReLU map and its 2048
seeded RoIs, in float32 and bfloat16, K3 with 1 and 3 seed batches. The
last lines are a JSON summary and the card's ``nvidia-smi --query-gpu=
name,power.limit`` line. Exits non-zero if a kernel does not build, does
not launch or disagrees, or without a card.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from nafwebsod_torch.ops import _build  # noqa: E402
from nafwebsod_torch.ops import roi_pool as rp  # noqa: E402

OUT_DIR = os.path.join(ROOT, 'build', 'port_k1k3_ab')
ATTIC = os.path.join(ROOT, 'scripts', 'attic')
SOURCES = {
    'k1_v1': (os.path.join(ATTIC, 'roi_pool_v1.cu'), ()),
    'k3_v1': (os.path.join(ATTIC, 'roi_pool_bwd_v1.cu'), ()),
    'k3_rescan': (os.path.join(ATTIC, 'roi_pool_bwd_rescan.cu'), ()),
    'k3_reads': (os.path.join(_build.CSRC, 'roi_pool_bwd.cu'),
                 ('-DROI_POOL_BWD_PART=1',)),
    'k3_atomics': (os.path.join(_build.CSRC, 'roi_pool_bwd.cu'),
                   ('-DROI_POOL_BWD_PART=2',)),
}
REPS = 50
SUFFIX = {torch.float32: 'f32', torch.bfloat16: 'bf16'}


def build():
    """Every library of SOURCES and the package's K1 and K3, one nvcc each,
    all at once. Returns {name: ctypes handle}."""
    os.makedirs(OUT_DIR, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = {}
    for name, (src, defines) in SOURCES.items():
        lib = os.path.join(OUT_DIR, 'lib%s.so' % name)
        cmd = [nvcc, *_build.NVCC_FLAGS, '-I', _build.CSRC, *defines, '-o',
               lib, src]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, report in _build.build(['roi_pool', 'roi_pool_bwd']).items():
        print('nvcc', name, ':', report.strip().replace('\n', ' | '),
              flush=True)
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed for %s:\n%s' % (name, out))
        print('nvcc', name, ':', out.strip().replace('\n', ' | '), flush=True)
        libs[name] = ctypes.CDLL(lib)
    return libs


def bind(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int

    def call(*args):
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError('%s: launch failed with cudaError %d' % (
                symbol, rc))
    return call


def stream():
    return torch.cuda.current_stream().cuda_stream


def k1_v1(lib, feat, rois):
    fn = bind(lib, 'roi_pool_fwd_' + SUFFIX[feat.dtype],
              [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 +
              [ctypes.c_float, ctypes.c_void_p])
    h, w, c = feat.shape
    r = rois.shape[0]

    def run():
        out = torch.empty((r, 7, 7, c), dtype=feat.dtype, device='cuda')
        fn(feat.data_ptr(), rois.data_ptr(), out.data_ptr(), h, w, c, r, 7,
           7, 0.125, stream())
        return out
    return run


def k3_v1(lib, feat, rois, g):
    fn = bind(lib, 'roi_pool_bwd_%s_%s' % (SUFFIX[feat.dtype],
                                           SUFFIX[g.dtype]),
              [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 +
              [ctypes.c_float, ctypes.c_void_p])
    h, w, c = feat.shape
    r = rois.shape[0]

    def run():
        dfeat = torch.zeros((g.shape[0], h, w, c), device='cuda')
        fn(feat.data_ptr(), rois.data_ptr(), g.data_ptr(), dfeat.data_ptr(),
           h, w, c, r, g.shape[0], 7, 7, 0.125, stream())
        return dfeat
    return run


def k3_rescan(lib, feat, rois, g):
    fn = bind(lib, 'roi_pool_bwd_rescan_' + SUFFIX[feat.dtype],
              [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 +
              [ctypes.c_float, ctypes.c_void_p])
    h, w, c = feat.shape
    r = rois.shape[0]
    n = rp.channels_per_load(feat)

    def run():
        dfeat = torch.zeros((g.shape[0], h, w, c), device='cuda')
        fn(feat.data_ptr(), rois.data_ptr(), g.data_ptr(), dfeat.data_ptr(),
           h, w, c, r, g.shape[0], 7, 7, n, 0.125, stream())
        return dfeat
    return run


def k3_part(lib, index, g, h, w):
    """A part of the scatter alone (its own build of csrc/roi_pool_bwd.cu)."""
    fn = bind(lib, 'roi_pool_bwd_' + SUFFIX[g.dtype],
              [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 +
              [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    c = index.shape[-1]

    def run():
        dfeat = torch.zeros((g.shape[0], h, w, c), device='cuda')
        fn(index.data_ptr(), g.data_ptr(), dfeat.data_ptr(), h, w, c,
           index.numel(), g.shape[0], stream())
        return dfeat
    return run


def in_turns(fns):
    """{name: [ms, ms]}: each fn timed twice, in the order given and then
    reversed."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(reversed(fns)):
        times[name].append(chip_smoke.time_ms(fns[name], REPS))
    return times


def main():
    chip_smoke.phase_device()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    libs = build()
    rng = np.random.RandomState(0)
    rois = torch.from_numpy(chip_smoke.k1_rois(rng, 2048, 917, 688)).cuda()
    base = torch.relu(torch.from_numpy(
        rng.randn(87, 119, 512).astype(np.float32))).cuda()
    ints = torch.from_numpy(rng.randint(-3, 4, (3, 2048, 7, 7, 512))
                            .astype(np.float32)).cuda()
    normal = torch.randn(3, 2048, 7, 7, 512, device='cuda',
                         generator=torch.Generator('cuda').manual_seed(0))
    h, w, _ = base.shape
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = SUFFIX[dtype]
        feat = base.to(dtype)
        want = rp.roi_pool_reference(feat, rois)
        old = k1_v1(libs['k1_v1'], feat, rois)
        _, index = rp.roi_pool_cuda(feat, rois, argmax=True)
        if not (torch.equal(old(), want) and torch.equal(
                rp.roi_pool_cuda(feat, rois), want) and torch.equal(
                    index, rp.roi_pool_argmax_reference(feat, rois))):
            raise AssertionError('K1 %s differs from the plain version' % name)
        t = in_turns({
            'v1': old,
            'new': lambda: rp.roi_pool_cuda(feat, rois),
            'new_with_index': lambda: rp.roi_pool_cuda(feat, rois,
                                                       argmax=True)})
        print('K1 %s: first design %s ms, new %s ms, new with the index %s '
              'ms' % (name, t['v1'], t['new'], t['new_with_index']),
              flush=True)
        summary['k1_' + name] = t
        index_ms = min(t['new_with_index']) - min(t['new'])
        for seeds in (1, 3):
            g_int = ints[:seeds].to(dtype)
            g = normal[:seeds].to(dtype)
            fns = {
                'v1': k3_v1(libs['k3_v1'], feat, rois, g),
                'a_scatter': lambda: rp.roi_pool_backward_cuda(index, g, h, w),
                'b_rescan': k3_rescan(libs['k3_rescan'], feat, rois, g)}
            exact = rp.roi_pool_backward_reference(feat, rois, g_int)
            checks = {
                'v1': k3_v1(libs['k3_v1'], feat, rois, g_int)(),
                'a_scatter': rp.roi_pool_backward_cuda(index, g_int, h, w),
                'b_rescan': k3_rescan(libs['k3_rescan'], feat, rois,
                                      g_int)()}
            for k, got in checks.items():
                if not torch.equal(got, exact):
                    raise AssertionError('K3 %s %s G=%d routes differently '
                                         'from the plain version' % (
                                             k, name, seeds))
            t = in_turns(fns)
            parts = {
                'a_reads_only': k3_part(libs['k3_reads'], index, g, h, w),
                'a_atomics_only': k3_part(libs['k3_atomics'], index, g, h,
                                          w)}
            t.update({k: [chip_smoke.time_ms(f, REPS)]
                      for k, f in parts.items()})
            t['a_index_in_forward'] = [index_ms]
            print('K3 %s G=%d: first design %s ms, (a) scatter %s ms (+ %.4f '
                  'ms for the index in the forward), (b) rescan %s ms; parts '
                  'of (a): reads only %s ms, atomics only %s ms' % (
                      name, seeds, t['v1'], t['a_scatter'], index_ms,
                      t['b_rescan'], t['a_reads_only'],
                      t['a_atomics_only']), flush=True)
            summary['k3_%s_g%d' % (name, seeds)] = t
    print(json.dumps(summary))
    print(smi)


if __name__ == '__main__':
    if not torch.cuda.is_available():
        sys.exit('port_k1k3_ab.py needs an NVIDIA GPU')
    main()
