"""The readings that the limits of `correct` are set from, at a cell's own
size on the chip (none of the benchmark's runs runs this):

    python3 -m portbench.proof --workload <cell> --seeds 1 2 3 ... \\
        [--program] [--control] [--faults frozen_state half_batch ...] \\
        [--seconds 2]

Each reading is a run of the cell (`run.outcome`, a short window), the
seeds and modes one after another in one process:

- `--program`: sound runs of the program;
- `--control`: the reference put in the program's place, computed in the
  nearest precision below the configuration's: float8 operands below
  bf16 (the training steps, the DDIM chain), TF32 below float32 with TF32
  off (the KL-VAE decode), held to the float32 reference by the cell's
  own checks (`faults.CONTROL`);
- `--faults`: the program with a fault of `faults.py` planted.

One JSON line per reading: the cell, what ran, the seed, `correct` as the
cell's checks decide it, and each number (compared by the cell or not)
with where it was found.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import run
from .faults import CONTROL
from .harness import REPO, ROOT, Context, load_json

__all__ = ["main", "reading"]


def _context(workload: str, seed: int, seconds: float) -> Context:
    cell = load_json(ROOT / "workloads" / f"{workload}.json")
    config = load_json(ROOT / "configs" / f"{cell['config']}.json")
    return Context(workload=workload, seed=seed, seconds=seconds,
                   trace=False, cell=cell, config=config,
                   started=time.perf_counter())


def reading(ctx: Context, bench: dict, mode: str, device="cuda") -> dict:
    """One run of the cell in `mode` ("program", "control" or a fault's
    name): {"correct", "numbers", "where"}."""
    fault = None if mode == "program" else mode
    code, record, line = run.outcome(ctx, bench, device, fault)
    if line is None:
        raise SystemExit(code)
    return {"correct": line["correct"],
            "numbers": {k: v[0] for k, v in record.notes.items()},
            "where": {k: v[1] for k, v in record.notes.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    bench = load_json(REPO / "BENCHMARK.json")
    modes = ((["program"] if args.program else [])
             + ([CONTROL] if args.control else []) + args.faults)
    for seed in args.seeds:
        for mode in modes:
            t0 = time.perf_counter()
            ctx = _context(args.workload, seed, args.seconds)
            found = reading(ctx, bench, mode)
            print(json.dumps({"workload": args.workload, "mode": mode,
                              "seed": seed,
                              "seconds": time.perf_counter() - t0,
                              **found}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
