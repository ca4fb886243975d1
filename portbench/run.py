"""Run one cell of the port's benchmark once and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. The cell is `portbench/workloads/<cell>.json`
(its configuration, traffic, chips, driver, traffic parameters and the
limits of its checks), its configuration `portbench/configs/<name>.json`,
its metrics those of `BENCHMARK.json` that name it, each read by
`portbench/metrics/<metric>.py`. `--trace 0` prints the cell's end-to-end
metrics, `--trace 1` its per-layer ones from a traced sub-window after
the measured window.

The last line of standard output is the JSON result; the numbers that
decide `correct` end it (under "checks") and are the last lines of
standard error. Without a CUDA device, or with fewer than the cell asks
for, the run exits with 2 and prints no result; with JAX, its libraries
or the JAX package loaded once the window has closed, with 3.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from .harness import (  # noqa: E402
    REPO,
    ROOT,
    Context,
    Record,
    forbidden_modules,
    load_json,
    mark,
    stderr,
)

__all__ = ["main", "execute", "outcome", "metrics_for", "read_metrics",
           "result_line"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def metrics_for(bench: dict, workload: str, trace: bool) -> list:
    """The metrics of BENCHMARK.json that `workload` reports: end-to-end
    ones with --trace 0, per-layer ones with --trace 1; a metric with a
    "workloads" list only in the cells it names."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def load_reader(name: str):
    """`portbench/metrics/<name>.py`'s `read(record)`."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: list, record: Record) -> dict:
    """{name: {"value", "unit"}} of the metrics whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value = load_reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_info(record: Record, trace: bool) -> dict:
    info = {"platform": "cpu" if record.device_kind == "cpu" else "gpu",
            "kind": record.device_kind,
            "count": record.chips,
            "memory_peak_bytes": int(record.memory_peak_bytes)}
    if trace and record.trace is not None:
        info["busy_s"] = record.trace["busy_s"]
        info["window_s"] = record.trace["window_s"]
    return info


def result_line(record: Record, metrics: dict, device: dict,
                trace: bool) -> dict:
    line = {"correct": record.correct, "attempted": record.attempted,
            "failed": record.failed, "metrics": metrics, "device": device}
    if trace and record.trace is not None:
        line["breakdown"] = {"device_ops": record.trace["device_ops"],
                             "idle_gaps": record.trace["idle_gaps"]}
    line["checks"] = {name: {"value": c.value, "limit": c.limit}
                      for name, c in record.checks.items()}
    return line


def context(args, started: float) -> Context:
    cell = load_json(ROOT / "workloads" / f"{args.workload}.json")
    config = load_json(ROOT / "configs" / f"{cell['config']}.json")
    return Context(workload=args.workload, seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace), cell=cell,
                   config=config, started=started)


def outcome(ctx: Context, bench: dict, device="cuda", fault=None):
    """Run the cell's driver on `device` and close the run's checks:
    (exit code, the driver's record, the result line), the line None
    where the run may print none. `fault` (a name of `faults.py`) breaks
    the timed path underneath, or puts the control in the program's
    place."""
    try:
        driver = importlib.import_module(
            f"portbench.drivers.{ctx.cell['driver']}")
        record = driver.run(ctx, device=device, fault=fault)
    finally:
        shutil.rmtree(ctx.scratch, ignore_errors=True)
    loaded = forbidden_modules()
    if loaded:
        stderr("JAX or the JAX package was loaded in this process: "
               + ", ".join(loaded[:20]))
        return 3, record, None
    metrics = read_metrics(metrics_for(bench, ctx.workload, ctx.trace),
                           record)
    return 0, record, result_line(record, metrics,
                                  device_info(record, ctx.trace), ctx.trace)


def execute(ctx: Context, bench: dict, device="cuda", fault=None) -> int:
    """`outcome`, printed: every number the run read on standard error,
    the result line as the last line of standard output, then each
    compared number beside its limit as the last lines of standard error;
    the look for a chip is `main`'s. Returns the exit code."""
    code, record, line = outcome(ctx, bench, device, fault)
    if line is None:
        return code
    for name, (value, where) in record.notes.items():
        stderr(f"[portbench] {name} {value!r} at {where}")
    print(json.dumps(line), flush=True)
    for name, check in record.checks.items():
        stderr(f"check {name} {check.value!r} limit {check.limit!r} "
               f"{'ok' if check.ok else 'FAILED'}")
    return code


def main(argv=None, started: float = STARTED) -> int:
    args = parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    bench = load_json(REPO / "BENCHMARK.json")
    ctx = context(args, started)
    import torch

    mark(ctx, "torch imported")
    chips = ctx.cell["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        stderr(f"{args.workload} needs {chips} CUDA device(s); found {found}")
        shutil.rmtree(ctx.scratch, ignore_errors=True)
        return 2
    torch.zeros(1, device="cuda")
    mark(ctx, "CUDA context made")
    return execute(ctx, bench)


if __name__ == "__main__":
    sys.exit(main())
