#!/bin/bash
# Run the cases of tests/test_torch_stats_gpu.py on the card, each in a
# pytest process of its own, all at once: these engines are host-bound at
# the JAX tests' small shapes, so the card is mostly idle and the cases
# share it.  Each case's log (with its gates' statistics, -rP) goes to
# OUT/<case>.log and its exit code and wall to OUT/exits.txt.
#
#   bash scripts/run_stats_gpu.sh [OUT] [TIMEOUT_S] [CASE ...]
#
# Run from the repository root on a machine with one CUDA card.  Without
# cases it runs every case of the file.
OUT=${1:-chiprun_out/stats_gpu}
LIMIT=${2:-3000}
if [ $# -ge 2 ]; then shift 2; else shift $#; fi
T="tests/test_torch_stats_gpu.py"
if [ $# -eq 0 ]; then
  mapfile -t CASES < <(python3 -m pytest --noconftest -o addopts="" \
    -p no:cacheprovider -m cuda --collect-only -q "$T" | grep "::" |
    sed 's/.*:://')
else
  CASES=("$@")
fi
mkdir -p "$OUT"
rm -f "$OUT/exits.txt"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for t in "${CASES[@]}"; do
  ( s=$(date +%s)
    timeout "$LIMIT" python3 -m pytest --noconftest -o addopts="" \
      -p no:cacheprovider -m cuda -rP -q --durations=3 "$T::$t" \
      > "$OUT/$t.log" 2>&1
    echo "$t rc=$? wall=$(( $(date +%s) - s )) s" >> "$OUT/exits.txt" ) &
done
wait
cat "$OUT/exits.txt"
for f in "$OUT"/*.log; do
  echo "== $f"
  grep -E "against|passed|failed|Error" "$f" | head -20
done
