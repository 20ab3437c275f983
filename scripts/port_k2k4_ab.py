"""The RoILoopPool and RoIAlign kernels' first designs against their
redesigns, on one card in one run.

    python3 scripts/port_k2k4_ab.py

Run it from the root of the checkout. It builds, one nvcc per source, all
started together, into build/port_k2k4_ab/:
  * K2, the ring pool: the first design (scripts/attic/roi_loop_pool_v1.cu)
    and the package's (nafwebsod_torch/ops/csrc/roi_loop_pool.cu);
  * K4, RoIAlign: the first design (scripts/attic/roi_align_v1.cu),
    candidate (b), each bin row's sample cells staged in shared memory
    (scripts/attic/roi_align_staged.cu), and candidate (a), K1's item
    split with a 16-byte load per corner, in its per-bin form
    (scripts/attic/roi_align_bin.cu) and as the package has it, a thread
    walking a run of seven bins (csrc/roi_align.cu);
  * and the package's K1 (csrc/roi_pool.cu), which shares
    csrc/roi_pool_scan.cuh with K2 and K4;
holds every one against its plain version first (bitwise; RoIAlign with
NaN in the same places), and then times old and new in turns (old, new,
new, old; K4: first design, (b), (a) per bin, (a), and back), each
reading the median of 50 CUDA-event timings after a warm-up, at
chip_smoke.py phase 3's shapes: an (87, 119, 512) ReLU map, in float32
and bfloat16; K2 on the frame and the context rois of the 2048
seeded proposals with the edge rows; K4 at 14x14 on the 2048 seeded RoIs
with the edge rows, at 14x14 on 100 of them (every 20th: mask inference's
count) and at 7x7 on the 2048 with the edge rows, all with 2x2 samples.
K1 (bf16 and float32) is checked and timed again beside them. The last
lines are a JSON summary and the card's ``nvidia-smi --query-gpu=
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
from nafwebsod_torch.ops import context as ctx  # noqa: E402
from nafwebsod_torch.ops import roi_pool as rp  # noqa: E402

OUT_DIR = os.path.join(ROOT, 'build', 'port_k2k4_ab')
ATTIC = os.path.join(ROOT, 'scripts', 'attic')
# the designs the package does not build: name -> source
ATTIC_DESIGNS = {'k2_v1': os.path.join(ATTIC, 'roi_loop_pool_v1.cu'),
                 'k4_v1': os.path.join(ATTIC, 'roi_align_v1.cu'),
                 'k4_b': os.path.join(ATTIC, 'roi_align_staged.cu'),
                 'k4_a_bin': os.path.join(ATTIC, 'roi_align_bin.cu')}
REPS = 50
SUFFIX = {torch.float32: 'f32', torch.bfloat16: 'bf16'}


def build():
    """ATTIC_DESIGNS, one nvcc each, all at once, beside the package's K1,
    K2 and K4. Returns {name: ctypes handle} of ATTIC_DESIGNS."""
    os.makedirs(OUT_DIR, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = {}
    for name, src in ATTIC_DESIGNS.items():
        lib = os.path.join(OUT_DIR, 'lib%s.so' % name)
        cmd = [nvcc, *_build.NVCC_FLAGS, '-I', _build.CSRC, '-o', lib, src]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, report in _build.build(['roi_pool', 'roi_loop_pool',
                                      'roi_align']).items():
        print('nvcc', name, ':', report.strip().replace('\n', ' | '),
              flush=True)
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed for %s:\n%s' % (name, out))
        print('nvcc', name, ':', out.strip().replace('\n', ' | '),
              flush=True)
        libs[name] = ctypes.CDLL(lib)
    return libs


def forward(lib, symbol, feat, rois, res, ints, out_dtype):
    """fn() launching ``symbol`` of ``lib`` with launch_pool_forward's
    arguments (``ints`` after the pooled width) into a new output."""
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * (6 + len(ints))
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    h, w, c = feat.shape
    r = rois.shape[0]

    def run():
        out = torch.empty((r, res, res, c), dtype=out_dtype, device='cuda')
        rc = fn(feat.data_ptr(), rois.data_ptr(), out.data_ptr(), h, w, c, r,
                res, res, *ints, 0.125,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError('%s: launch failed with cudaError %d' % (
                symbol, rc))
        return out
    return run


def in_turns(fns):
    """{name: [ms, ms]}: each fn timed twice, in the order given and then
    reversed."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(reversed(fns)):
        times[name].append(chip_smoke.time_ms(fns[name], REPS))
    return times


def k2_cases(libs, feat, streams):
    """{label: {design: fn}} of K2, each checked against the plain
    version."""
    cases = {}
    sfx = SUFFIX[feat.dtype]
    for stream, rois9 in streams.items():
        want = ctx.roi_loop_pool_reference(feat, rois9)
        fns = {'v1': forward(libs['k2_v1'], 'roi_loop_pool_fwd_' + sfx,
                             feat, rois9, 7, (), feat.dtype),
               'new': lambda r=rois9: ctx.roi_loop_pool_cuda(feat, r)}
        for design, fn in fns.items():
            if not torch.equal(fn(), want):
                raise AssertionError('K2 %s %s %s rois differs from the plain '
                                     'version' % (design, sfx, stream))
        cases['k2_%s_%s' % (sfx, stream)] = fns
    return cases


def k4_cases(libs, feat, rois_by_shape):
    """{label: {design: fn}} of K4, each checked against the plain
    version."""
    cases = {}
    sfx = SUFFIX[feat.dtype]
    for label, (rois, res) in rois_by_shape.items():
        want = rp.roi_align_reference(feat, rois, res, res, 0.125, 2)
        ints = (2, rp.channels_per_load(feat))
        fns = {'v1': forward(libs['k4_v1'], 'roi_align_fwd_' + sfx, feat,
                             rois, res, (2,), torch.float32),
               'b_staged': forward(libs['k4_b'], 'roi_align_fwd_' + sfx,
                                   feat, rois, res, ints, torch.float32),
               'a_bin': forward(libs['k4_a_bin'], 'roi_align_fwd_' + sfx,
                                feat, rois, res, ints, torch.float32),
               'a_run': lambda r=rois, p=res: rp.roi_align_cuda(
                   feat, r, p, p, 0.125, 2)}
        for design, fn in fns.items():
            if not chip_smoke.same_with_nans(fn(), want):
                raise AssertionError('K4 %s %s %s differs from the plain '
                                     'version' % (design, sfx, label))
        cases['k4_%s_%s' % (sfx, label)] = fns
    return cases


def main():
    chip_smoke.phase_device()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    libs = build()
    rng = np.random.RandomState(0)
    proposals = torch.from_numpy(chip_smoke.k1_rois(rng, 2048, 917, 688))
    base = torch.relu(torch.from_numpy(
        rng.randn(87, 119, 512).astype(np.float32))).cuda()
    proposals = proposals.cuda()
    ring_edge = torch.tensor(chip_smoke.K2_EDGE_ROIS, dtype=torch.float32,
                             device='cuda')
    streams = {name: torch.cat([rois9, ring_edge]).contiguous()
               for name, rois9 in zip(('frame', 'context'), ctx.roi_context(
                   proposals, 688, 917, 1.8))}
    align_rois = torch.cat([proposals, torch.tensor(
        chip_smoke.K4_EDGE_ROIS, dtype=torch.float32, device='cuda')])
    rois_by_shape = {'14x14_r%d' % len(align_rois): (align_rois, 14),
                     '14x14_r100': (proposals[::20][:100].contiguous(), 14),
                     '7x7_r%d' % len(align_rois): (align_rois, 7)}
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        feat = base.to(dtype)
        sfx = SUFFIX[dtype]
        if not torch.equal(rp.roi_pool_cuda(feat, proposals),
                           rp.roi_pool_reference(feat, proposals)):
            raise AssertionError('K1 %s differs from the plain version' % sfx)
        summary['k1_%s' % sfx] = in_turns(
            {'new': lambda: rp.roi_pool_cuda(feat, proposals)})['new']
        print('K1 %s: %s ms' % (sfx, summary['k1_%s' % sfx]), flush=True)
        cases = k2_cases(libs, feat, streams)
        cases.update(k4_cases(libs, feat, rois_by_shape))
        for label, fns in cases.items():
            summary[label] = in_turns(fns)
            print('%s: %s' % (label, ', '.join(
                '%s %s ms' % (design, ms)
                for design, ms in summary[label].items())), flush=True)
    print(json.dumps(summary))
    print(smi)


if __name__ == '__main__':
    if not torch.cuda.is_available():
        sys.exit('port_k2k4_ab.py needs an NVIDIA GPU')
    main()
