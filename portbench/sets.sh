#!/usr/bin/env bash
# The spread runs of one-chip cells on one card: a build run, then per cell
# two sets of <per_set> runs on the same seeds (--trace 0) and <traced>
# traced runs on other seeds, each run its own process; the seeds start at
# <base>. Writes chiprun_out/sets/<cell>/.
#   bash portbench/sets.sh <base> <seconds> <per_set> <traced> <cell> [<cell> ...]
set -u
base=$1; seconds=$2; per_set=$3; traced=$4; shift 4
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -m portbench.run --workload "$1" --seed 1 --seconds 2 --trace 0 \
  > /dev/null 2>&1  # builds the kernels: every later run finds them built
for cell in "$@"; do
  runs=()
  for set in a b; do
    for s in $(seq "$base" $((base + per_set - 1))); do
      runs+=("$cell:$s:$seconds:0")
    done
  done
  for s in $(seq $((base + 50)) $((base + 49 + traced))); do
    runs+=("$cell:$s:$seconds:1")
  done
  python3 -m portbench.series --out "chiprun_out/sets/$cell" --spread \
    --runs "${runs[@]}" | cut -c1-600
done
