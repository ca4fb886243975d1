"""Device time of the VQ nearest-code kernel (`csrc/vq.cu`) on the card, for
the package's source and for other copies of it, all in one process.

    python3 -m vqgan_tpu_torch.bench_vq
    python3 -m vqgan_tpu_torch.bench_vq --variant wide=other/vq.cu

A variant is NAME=PATH, a copy of `csrc/vq.cu` with the same C entry point
(it finds the package's headers, as `csrc/` is on its include path);
"shipped" (the package's source as it is) is always first. Each variant is
built by its own nvcc, all at once, into a temporary directory, checked once
against the plain version (the rows whose index differs, usage against
bincount), then timed: `--iters` bare launches on pre-staged inputs captured
in one CUDA graph, replayed, timed by CUDA events, the variants in turns for
`--rounds` rounds. Prints one JSON line per variant (median device ms per
shape and mode, the registers and spills ptxas reports), then the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from .device import resolve_device, set_full_fp32_precision
from .kernels.build import CSRC, NVCC_FLAGS, nvcc_path
from .kernels.vq import DTYPES, MODES, VQ_NEAREST, staged
from .ops.vq import codebook_usage, vq_lookup_reference

SHAPES = {"vqgan_main": (8192, 128, 256), "bench_k8192": (8192, 8192, 256)}


def parse_variants(specs) -> dict:
    """{name: source path} from NAME=PATH specs, "shipped" first."""
    sources = {"shipped": VQ_NEAREST.source}
    for spec in specs:
        name, _, path = spec.partition("=")
        if not name or name in sources or not path.endswith(".cu"):
            raise ValueError(f"a variant is NAME=PATH of a .cu file under a "
                             f"new name, got {spec!r}")
        sources[name] = Path(path)
    return sources


def _start_build(name: str, source: Path, out_dir: Path):
    out = out_dir / f"lib{name}.so"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
           str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out


def _load(out: Path):
    fn = getattr(ctypes.CDLL(str(out)), VQ_NEAREST.symbol)
    fn.argtypes = VQ_NEAREST.argtypes
    fn.restype = ctypes.c_int
    return fn


def _graph_ms(fn, iters: int) -> float:
    """Device ms of one `fn()`: `iters` calls in one CUDA graph, replayed
    three times after a warm-up replay."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES),
                    choices=list(SHAPES))
    ap.add_argument("--modes", nargs="+", default=list(MODES),
                    choices=list(MODES))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    sources = parse_variants(args.variant)
    device = resolve_device("cuda")
    set_full_fp32_precision()
    with tempfile.TemporaryDirectory(prefix="bench_vq_") as tmp:
        started = {name: _start_build(name, src, Path(tmp))
                   for name, src in sources.items()}
        fns, logs = {}, {}
        for name, (proc, out) in started.items():
            logs[name], _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed for {name}:\n{logs[name]}")
            fns[name] = _load(out)

        rng = np.random.default_rng(args.seed)
        cases = []
        for label in args.shapes:
            n, k, d = SHAPES[label]
            z = torch.from_numpy(rng.standard_normal((n, d)).astype(
                np.float32)).to(device)
            cb = torch.from_numpy(rng.standard_normal((k, d)).astype(
                np.float32)).to(device)
            e_sq = (cb * cb).sum(1)
            for mode in args.modes:
                zs, es = staged(z, DTYPES[mode]), staged(cb, DTYPES[mode])
                _, ref = vq_lookup_reference(z, cb, mode)
                args_of = (zs.data_ptr(), es.data_ptr(), e_sq.data_ptr())
                cases.append((f"{label} {mode}", n, k, zs, es, e_sq,
                              MODES[mode], ref, args_of))

        results = {name: {"flips": {}, "ms": {}} for name in fns}
        times = {name: {c[0]: [] for c in cases} for name in fns}
        for name, fn in fns.items():
            for key, n, k, zs, es, e_sq, mode, ref, ins in cases:
                idx = torch.empty(n, dtype=torch.int32, device=device)
                usage = torch.zeros(k, dtype=torch.int32, device=device)
                err = fn(*ins, idx.data_ptr(), usage.data_ptr(), n, k,
                         zs.shape[1], mode,
                         torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                if err != 0:
                    raise SystemExit(f"{name} {key}: launch error {err}")
                if not torch.equal(usage, codebook_usage(idx, k)):
                    raise SystemExit(f"{name} {key}: usage != bincount")
                results[name]["flips"][key] = int((idx != ref).sum())
        for _ in range(args.rounds):
            for name, fn in fns.items():
                for key, n, k, zs, es, e_sq, mode, _, ins in cases:
                    idx = torch.empty(n, dtype=torch.int32, device=device)
                    usage = torch.zeros(k, dtype=torch.int32, device=device)
                    ptrs = (*ins, idx.data_ptr(), usage.data_ptr(), n, k,
                            zs.shape[1], mode)

                    def launch(fn=fn, ptrs=ptrs):
                        fn(*ptrs, torch.cuda.current_stream().cuda_stream)

                    times[name][key].append(_graph_ms(launch, args.iters))
    for name in fns:
        results[name]["ms"] = {key: statistics.median(v)
                               for key, v in times[name].items()}
        results[name]["ptxas"] = [
            line.strip() for line in logs[name].splitlines()
            if "registers" in line or "spill" in line]
        print(json.dumps({"variant": name, "source": str(sources[name]),
                          **results[name]}))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    return results


if __name__ == "__main__":
    main()
