#!/bin/sh
# A/B of chip_smoke.py on one card: the parent tree, this tree, this tree,
# the parent tree, in turn, in one process each (each tree builds its own
# libraries).
#
#   sh aozora_sdxl_training_tpu_torch/tools/ab_chip_smoke.sh PARENT OUT PHASES [--trace]
#
# Run from the root of a checkout. PARENT is an unpacked parent tree (e.g.
# `git archive <commit> | tar -x -C ab/parent`), OUT a directory for the
# logs, PHASES chip_smoke.py's --only list (e.g. kernels,k5,anima). Run i
# writes OUT/i-{parent,change}.log and its CHIP_SMOKE_LOG_DIR is
# OUT/i-{parent,change}. With --trace each run also sets AOZORA_PROFILE_DIR
# to OUT/i-{parent,change}/trace (train/profiling.py: micro steps 3-8 of
# each trainer) and keeps its summary.json and kernels.txt, not the trace.
set -u
[ $# -ge 3 ] || { echo "usage: $0 PARENT OUT PHASES [--trace]" >&2; exit 2; }
root=$(pwd)
parent=$(cd "$1" && pwd) || exit 2
mkdir -p "$2" && out=$(cd "$2" && pwd) || exit 2
phases=$3
trace=${4:-}
status=0
i=0
for tree in "$parent" "$root" "$root" "$parent"; do
  i=$((i + 1))
  if [ "$tree" = "$root" ]; then name=change; else name=parent; fi
  run="$out/$i-$name"
  mkdir -p "$run"
  echo "=== run $i: $name ($tree) $(date +%T)"
  if [ "$trace" = "--trace" ]; then
    (cd "$tree" && CHIP_SMOKE_LOG_DIR="$run" AOZORA_PROFILE_DIR="$run/trace" \
       timeout 900 python3 chip_smoke.py --only "$phases") > "$run.log" 2>&1
  else
    (cd "$tree" && CHIP_SMOKE_LOG_DIR="$run" \
       timeout 900 python3 chip_smoke.py --only "$phases") > "$run.log" 2>&1
  fi
  rc=$?
  echo "rc=$rc"
  [ $rc -eq 0 ] || status=1
  grep -E "^  flash_|^  (flash_fwd_stats|flash_bwd_stats) |forward \+ backward|s/micro-step|losses|max_memory|^  launches|FAIL|^total|HGMMA|sites a forward|by site|by kernel|SDXL_BASE UNet|fused_gn True" \
    "$run.log" | cut -c1-260
  find "$run" -name trace.json.gz -delete 2>/dev/null
  for summary in "$run"/trace/*/summary.json; do
    [ -f "$summary" ] && python3 -c "import json, sys; s = json.load(open(sys.argv[1])); \
print(sys.argv[1], 'wall_s', s['wall_s'], 'device_busy_s', s['device_busy_s'], \
'device_busy_share', s['device_busy_share'])" "$summary"
  done
done
exit $status
