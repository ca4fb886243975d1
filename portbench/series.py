"""Run cells several times in a row, one process a run, as the check runs
them, and summarise: the tool behind the spreads and the seeds in
PERF.md.

    python3 -m portbench.series --out chiprun_out/sets \\
        --runs vqgan256_train_gd:101:30:0 vqgan256_train_gd:102:30:0 ...

Each run is `workload:seed:seconds:trace`. Every run's standard output and
error go to `<out>/<n>-<workload>-<seed>-<trace>.{out,err}`; one JSON line
per run (its exit code, seconds on the host clock and result line) goes
to standard output and to `<out>/summary.jsonl`. `--spread` then prints,
per workload and trace setting, each metric's median and the distance
between its quartiles as a share of the median (Python's
`statistics.quantiles(values, n=4)`).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

__all__ = ["main", "spread"]


def spread(values) -> float:
    """(Q3 - Q1) / median, by `statistics.quantiles(values, n=4)`."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--runs", nargs="+", required=True)
    ap.add_argument("--spread", action="store_true")
    ap.add_argument("--timeout", type=float, default=1500.0)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rows = []
    for i, run in enumerate(args.runs):
        workload, seed, seconds, trace = run.split(":")
        stem = out / f"{i:02d}-{workload}-{seed}-{trace}"
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "portbench.run", "--workload", workload,
               "--seed", seed, "--seconds", seconds, "--trace", trace]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=args.timeout)
            code, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            code, stdout, stderr = 124, e.stdout or "", e.stderr or ""
            stdout = stdout if isinstance(stdout, str) else stdout.decode()
            stderr = stderr if isinstance(stderr, str) else stderr.decode()
        wall = time.perf_counter() - t0
        stem.with_suffix(".out").write_text(stdout)
        stem.with_suffix(".err").write_text(stderr)
        result = None
        lines = stdout.strip().splitlines()
        if code == 0 and lines:
            result = json.loads(lines[-1])
        row = {"workload": workload, "seed": int(seed), "trace": int(trace),
               "code": code, "wall_s": wall, "result": result}
        if result is None:
            row["stderr_tail"] = stderr[-1500:]
        rows.append(row)
        print(json.dumps(row), flush=True)
        with open(out / "summary.jsonl", "a") as f:
            f.write(json.dumps(row) + "\n")
    if args.spread:
        groups = defaultdict(lambda: defaultdict(list))
        for row in rows:
            if row["result"]:
                key = (row["workload"], row["trace"])
                for name, m in row["result"]["metrics"].items():
                    groups[key][name].append(m["value"])
        for (workload, trace), metrics in groups.items():
            for name, values in metrics.items():
                if len(values) >= 2:
                    print(json.dumps({
                        "workload": workload, "trace": trace, "metric": name,
                        "n": len(values), "median": statistics.median(values),
                        "spread": spread(values) if len(values) >= 3
                        else None, "values": values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
