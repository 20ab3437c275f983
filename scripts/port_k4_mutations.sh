#!/bin/bash
# Mutation check of the port's RoIAlign kernel, for a machine with a card:
# each mutation of csrc/roi_align.cu is made in a throw-away copy of the
# sources, and the K4 phase of the smoke (scripts/port_k4_first_call.py)
# must fail on every one of them. Run from the root of the checkout:
#
#     bash scripts/port_k4_mutations.sh
#
# Prints one "MUTATION <name>: rc=<exit code> <last error line>" per
# mutation; rc=0 means the mutation went unnoticed. The last entry changes
# nothing and says so.
set -u
root=$(pwd)
cu=nafwebsod_torch/ops/csrc/roi_align.cu
run() {
  name=$1; shift
  work=$(mktemp -d)
  mkdir -p "$work/scripts"
  cp -r chip_smoke.py nafwebsod_torch "$work/"
  cp scripts/port_k4_first_call.py "$work/scripts/"
  (
    cd "$work" && "$@" "$cu"
    if cmp -s "$cu" "$root/$cu"; then
      echo "MUTATION $name: the edit changed nothing"
    else
      python3 scripts/port_k4_first_call.py > out.txt 2>&1
      rc=$?
      echo "MUTATION $name: rc=$rc $(grep -E 'AssertionError|RuntimeError|error' out.txt | tail -1 | cut -c1-200)"
    fi
  )
  rm -rf "$work"
}
run open_upper sed -i 's/coord <= top/coord < top/'
run open_lower sed -i 's/coord >= -1.f/coord > -1.f/'
run no_validity sed -i 's/v = __fmul_rn(v, __fmul_rn(y.valid, x.valid));//'
run fma sed -i 's/v = __fadd_rn(v, __fmul_rn(__fmul_rn(f01, hy), x.frac));/v = fmaf(__fmul_rn(f01, hy), x.frac, v);/'
run rounded_coords sed -i 's/const float start_w = __fmul_rn(roi\[1\], spatial_scale);/const float start_w = rintf(__fmul_rn(roi[1], spatial_scale));/'
run broken_build sed -i 's/__syncthreads();/__syncthreads()/'
run unchanged sed -i 's/zzzz/zzzz/'
