#!/bin/bash
# Mutation check of the port's RoIPoolF kernels, for a machine with a card:
# each mutation of csrc/roi_pool_scan.cuh (K1's scan) or csrc/roi_pool_bwd.cu
# (K3) is made in a throw-away copy of the sources, and the K1 and K3
# phases of the smoke (chip_smoke.py phase 3) must fail on every one of
# them. Run from the root of the checkout:
#
#     bash scripts/port_k1k3_mutations.sh
#
# Prints one "MUTATION <name>: rc=<exit code> <last error line>" per
# mutation; rc=0 means the mutation went unnoticed. A pattern that is not
# in the source is reported as such.
set -u
scan=nafwebsod_torch/ops/csrc/roi_pool_scan.cuh
bwd=nafwebsod_torch/ops/csrc/roi_pool_bwd.cu
run() {
  local name=$1 file=$2 from=$3 to=$4
  local work
  work=$(mktemp -d)
  cp -r chip_smoke.py nafwebsod_torch "$work/"
  (
    cd "$work" || exit 1
    if ! grep -qF -- "$from" "$file"; then
      echo "MUTATION $name: pattern not found in $file"
      exit 0
    fi
    python3 - "$file" "$from" "$to" <<'PY'
import sys
path, old, new = sys.argv[1:]
with open(path) as f:
    text = f.read()
with open(path, 'w') as f:
    f.write(text.replace(old, new, 1))
PY
    timeout 300 python3 -c "
import chip_smoke as c
c.phase_device(); c.phase_build(); c.phase_k1(); c.phase_k3()" \
      > out.txt 2>&1
    rc=$?
    echo "MUTATION $name: rc=$rc $(grep -E 'AssertionError|RuntimeError|error' out.txt | tail -1 | cut -c1-200)"
  )
  rm -rf "$work"
}
# K1: the last max instead of the first, NaN dropped in float32 and in
# bf16, a non-finite max kept
run last_max $scan 'if (f > a.m[i]) {' 'if (f >= a.m[i]) {'
run f32_drops_nan $scan 'asm("max.NaN.f32' 'asm("max.f32'
run bf16_drops_nan $scan '__hmax2_nan(' '__hmax2('
run finite_ignored $scan 'return isfinite(to_float(top.v[i]));' 'return true;'
# K3: a wrong channel for every element after a lane's first, negative
# cotangents dropped
run channel_step $bwd 'c += 32;' 'c += 31;'
run positive_only $bwd '} else if (cell >= 0 && v != 0.f) {' \
  '} else if (cell >= 0 && v > 0.f) {'
