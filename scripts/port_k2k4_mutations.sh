#!/bin/bash
# Mutation check of the port's RoILoopPool (K2) and RoIAlign (K4) kernels,
# for a machine with a card: each mutation of csrc/roi_loop_pool.cu,
# csrc/roi_align.cu or the scan header they share with K1 is made in a
# throw-away copy of the sources, and the kernel's check in the smoke's
# phase 3 (chip_smoke.py phase_k2 or phase_k4) must fail on every one of
# them. Run from the root of the checkout:
#
#     bash scripts/port_k2k4_mutations.sh
#
# Prints one "MUTATION <name>: rc=<exit code> <last error line>" per
# mutation; rc=0 means the mutation went unnoticed. A pattern that is not
# in the source is a failure of this script, not a pass: the script then
# says so and, like an unnoticed mutation, makes the exit code 1.
set -u
ring=nafwebsod_torch/ops/csrc/roi_loop_pool.cu
align=nafwebsod_torch/ops/csrc/roi_align.cu
scan=nafwebsod_torch/ops/csrc/roi_pool_scan.cuh
failed=0
run() {
  local name=$1 phase=$2 file=$3 from=$4 to=$5
  local work rc
  work=$(mktemp -d)
  cp -r chip_smoke.py nafwebsod_torch "$work/"
  (
    cd "$work" || exit 2
    python3 - "$file" "$from" "$to" <<'PY' || exit 2
import sys
path, old, new = sys.argv[1:]
with open(path) as f:
    text = f.read()
if old not in text:
    sys.exit(1)
with open(path, 'w') as f:
    f.write(text.replace(old, new, 1))
PY
    timeout 300 python3 -c "
import chip_smoke as c
c.phase_device(); c.phase_build(); c.$phase()" > out.txt 2>&1
    rc=$?
    echo "MUTATION $name: rc=$rc $(grep -E 'AssertionError|RuntimeError|error' out.txt | tail -1 | cut -c1-200)"
    [ $rc -ne 0 ]
  )
  rc=$?
  if [ $rc -eq 2 ]; then
    echo "MUTATION $name: pattern not found in $file: the script is out of date"
  fi
  [ $rc -eq 0 ] || failed=1
  rm -rf "$work"
}
# K2: the inner box's open interior taken as closed, the 0 floor dropped,
# NaN dropped from the max in float32 and in bf16, a NaN or +inf ring kept
run closed_interior phase_k2 $ring \
  'q.x0 = min(max(ix1 + 1, q.ws), q.we);' 'q.x0 = min(max(ix1, q.ws), q.we);'
run no_floor phase_k2 $ring \
  'roi_pool::from_float(0.f, acc.v[k]);' \
  'roi_pool::from_float(-INFINITY, acc.v[k]);'
run f32_drops_nan phase_k2 $scan 'asm("max.NaN.f32' 'asm("max.f32'
run bf16_drops_nan phase_k2 $scan '__hmax2_nan(' '__hmax2('
run non_finite_kept phase_k2 $ring 'isfinite(m) ? m : 0.f' 'm'
# K4: the validity interval open at its upper or its lower end, no
# validity product, a product and sum contracted into an FMA, rounded RoI
# coordinates, the upper corners read from the lower row, and a build that
# fails
run open_upper phase_k4 $align 'coord <= top' 'coord < top'
run open_lower phase_k4 $align 'coord >= -1.f' 'coord > -1.f'
run no_validity phase_k4 $align 'if (valid != 1.f) v = __fmul_rn(v, valid);' ''
run fma phase_k4 $align \
  $'v = __fadd_rn(v, __fmul_rn(__fmul_rn(to_float(f01.v[k]), hy),\n                                   x.frac));' \
  'v = fmaf(__fmul_rn(to_float(f01.v[k]), hy), x.frac, v);'
run rounded_coords phase_k4 $align \
  'const float start_w = __fmul_rn(roi[1], spatial_scale);' \
  'const float start_w = rintf(__fmul_rn(roi[1], spatial_scale));'
run upper_row phase_k4 $align \
  'const T* row1 = fc + y.c1 * row_stride;' \
  'const T* row1 = fc + y.c0 * row_stride;'
run broken_build phase_k4 $align '__syncthreads();' '__syncthreads()'
exit $failed
