#!/usr/bin/env bash
# The runs that set a cell's bounds, all in one call on the card:
#   bash bench/tools/sets.sh <out> <cell> <seconds> <first seed> [runs] [traced]
# two sets of [runs] (default 6) runs on the same seeds (first seed ..
# first seed + runs - 1), then [traced] (default 3) runs with --trace 1 on
# the next seeds; each run's standard output and error go to
# <out>/<cell>/.  The cell stops at its first run that fails or is not
# correct.  Read them with python3 bench/tools/spread.py <out>/<cell>.
set -u
out=$1/$2; cell=$2; secs=$3; seed0=$4; runs=${5:-6}; traced=${6:-3}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$out/card.txt"

one() {  # <file stem> <seed> <trace>
  python3 bench/run.py --workload "$cell" --seed "$2" --seconds "$secs" \
    --trace "$3" > "$out/$1.out" 2> "$out/$1.err"
  local rc=$?
  echo "$1 rc=$rc $(tail -n 1 "$out/$1.out" | cut -c1-600)"
  [ "$rc" = 0 ] && tail -n 1 "$out/$1.out" | grep -q '"correct": true' || exit 1
}

for s in 1 2; do
  for i in $(seq 0 $((runs - 1))); do
    one "set$s.$((seed0 + i))" $((seed0 + i)) 0
  done
done
for i in $(seq 1 "$traced"); do
  one "trace.$((seed0 + runs - 1 + i))" $((seed0 + runs - 1 + i)) 1
done
