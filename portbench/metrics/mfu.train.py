"""The whole training step's share of the cards' bf16 peak, in %: the
FLOPs of one step counted on the benchmark's plain reference (forward and
backward at the global batch, `portbench/work.py`'s rules) times the
measured window's steps, over its seconds and 989 TFLOP/s per chip."""

from portbench import work


def read(record):
    flops = record.work.get("step_flops")
    host = record.host
    if not flops or not host.get("steps"):
        return None
    peak = work.PEAKS["H100"]["bfloat16"] * record.chips
    return 100.0 * flops * host["steps"] / host["window_s"] / peak
