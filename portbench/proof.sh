#!/usr/bin/env bash
# The readings behind one cell's limits of `correct`, on one card: sound
# runs of the program, the control in the program's place, then the
# planted faults, each on its own seeds (from <base>, <base> + 100 and
# <base> + 200), all in one process (`portbench.proof`). Writes
# chiprun_out/proof/<cell>.jsonl.
#   bash portbench/proof.sh <base> <cell> <n_program> <n_control> <n_fault> [<fault> ...]
set -u
base=$1; cell=$2; n_program=$3; n_control=$4; n_fault=$5; shift 5
out=chiprun_out/proof
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
run() {  # <mode flags> <first seed> <count>
  local flags=$1 first=$2 n=$3
  [ "$n" -gt 0 ] || return 0
  python3 -m portbench.proof --workload "$cell" $flags \
    --seeds $(seq "$first" $((first + n - 1))) \
    >> "$out/$cell.jsonl" 2>> "$out/$cell.err"
}
run --program "$base" "$n_program"
run --control $((base + 100)) "$n_control"
[ $# -gt 0 ] && run "--faults $*" $((base + 200)) "$n_fault"
cut -c1-600 "$out/$cell.jsonl"
