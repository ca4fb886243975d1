"""Microbenchmark of the VQ nearest-code kernel (`csrc/vq.cu`) on the card,
in two modes.

    python3 -m vqgan_tpu_torch.bench_vq [--n 8192] [--k 1024 8192 16384] \
        [--d 256] [--iters 50]
    python3 -m vqgan_tpu_torch.bench_vq --variant wide=other/vq.cu

By default it is the counterpart of cli/bench_vq.py, with its flags and
defaults: for each codebook size K, z [N, D] ~ N(0, 1) and a codebook
[K, D] ~ N(0, 0.01) from `--seed` and K, then three routes, each over
`--iters` calls chained as the JAX CLI chains them (z <- z + z_q x 1e-20,
the sum of z_q[0, 0] carried), one untimed chain first and one timed:
- "library": addmm + argmin + index_select in fp32 (TF32 off), the JAX
  CLI's "xla" route in stock PyTorch calls;
- "kernel": the port's `vq_lookup` with use_kernel True, the kernel's bf16
  mode, as the JAX CLI's "pallas" row calls it;
- "kernel_fp32": `vq_lookup` with "auto", the exact mode the VQ-GAN's
  main path runs.
Timed by CUDA events around the chain on the card, so a host slower than
the device shows in the time (the host clock with `--device cpu`, the
kernel's plain version in its place). Prints one JSON line per route and
K: us per call, effective GB/s by the JAX CLI's formula ((2 N D + K D) x 4
bytes per call), FLOPs, least bytes, bounds, bound share and MFU as in
`bench_attention` (the compute bound at bf16 for "kernel", at fp32 for the
other two), the launches per call, and the indices of one unchained
call of each route (`main` returns them) for a caller to compare; then the
card's name and power limit.

With one or more `--variant`, it times the package's source beside
copies of it, all in one process. A variant is NAME=PATH, a copy of
`csrc/vq.cu` with the same C entry point (it finds the package's headers,
as `csrc/` is on its include path); "shipped" (the package's source as it
is) is always first. Each variant is built by its own nvcc, all at once,
into a temporary directory, checked once against the plain version (the
rows whose index differs, usage against bincount), then timed:
`COPIES_ITERS` bare launches on pre-staged inputs captured in one CUDA graph, replayed,
timed by CUDA events, the variants in turns for `--rounds` rounds, at the
two named `--shapes`. Prints one JSON line per variant (median device ms
per shape and mode, the registers and spills ptxas reports), then the
card's name and power limit. This mode needs a card.
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

from .bench_attention import bound_fields, chain_ms
from .bench_sampling import device_line
from .device import resolve_device, set_full_fp32_precision
from .kernels.build import CSRC, NVCC_FLAGS, nvcc_path
from .kernels.vq import DTYPES, MODES, VQ_NEAREST, staged
from .ops.vq import codebook_usage, vq_lookup, vq_lookup_reference
from .utils.flops import count_work, flops_report

SHAPES = {"vqgan_main": (8192, 128, 256), "bench_k8192": (8192, 8192, 256)}
COPIES_ITERS = 20  # bare launches per CUDA graph in the copies mode


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


def library_lookup(z, codebook):
    """(z_q, indices) by stock calls: addmm for the scores, argmin,
    index_select."""
    e_sq = (codebook * codebook).sum(1)
    dist = torch.addmm((z * z).sum(1, keepdim=True) + e_sq, z,
                       codebook.t(), alpha=-2.0)
    idx = torch.argmin(dist, dim=1)
    return codebook.index_select(0, idx), idx


def _chained(fn, z, codebook):
    """One call chained as the JAX CLI chains them: (z + z_q x 1e-20,
    z_q)."""
    zq, _ = fn(z, codebook)
    return z + zq * 1e-20, zq


# {route: (z, codebook) -> (z_q, indices)}
ROUTES = {
    "library": library_lookup,
    "kernel": lambda z, cb: vq_lookup(z, cb, True)[:2],
    "kernel_fp32": lambda z, cb: vq_lookup(z, cb, "auto")[:2],
}


def bench_routes(args) -> list:
    """The JAX CLI's interface: one row per K and route (see the module
    docstring), each with the indices of one unchained call."""
    device = resolve_device(args.device)
    set_full_fp32_precision()
    card = device_line(device)
    print(f"device: {card}, N={args.n}, D={args.d}")
    rows = []
    for k in args.k:
        gen = torch.Generator(device).manual_seed(args.seed + k)
        z = torch.randn((args.n, args.d), generator=gen, device=device)
        cb = torch.randn((k, args.d), generator=gen, device=device) * 0.1
        for route, fn in ROUTES.items():
            _, idx = fn(z, cb)
            flops, n_bytes = count_work(fn, z, cb)
            before = VQ_NEAREST.launches
            ms = chain_ms(lambda zc, fn=fn: _chained(fn, zc, cb), z,
                          args.iters)
            gb = (args.n * args.d * 2 + k * args.d) * 4 / 1e9
            dt = "bfloat16" if route == "kernel" else "float32"
            row = {"n": args.n, "k": k, "d": args.d, "route": route,
                   "us": ms * 1e3, "gb_per_s": gb / (ms / 1e3),
                   **flops_report(flops, ms / 1e3, device),
                   **bound_fields(flops, n_bytes, ms, dt, device),
                   "launches_per_call": (VQ_NEAREST.launches - before)
                   / (2 * args.iters), "device": card}
            print(json.dumps(row))
            rows.append({**row, "z": z, "codebook": cb, "indices": idx})
    print(card)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=8192,
                    help="flattened spatial positions (B*H*W)")
    ap.add_argument("--k", type=int, nargs="+",
                    default=[1024, 8192, 16384])
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--iters", type=int, default=50,
                    help="calls per timed chain")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH",
                    help="time the package's vq.cu beside this copy of it")
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES),
                    choices=list(SHAPES))
    ap.add_argument("--modes", nargs="+", default=list(MODES),
                    choices=list(MODES))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not args.variant:
        return bench_routes(args)
    return bench_copies(args)


def bench_copies(args) -> dict:
    """Copies of `csrc/vq.cu` side by side (see the module docstring)."""
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

                    times[name][key].append(_graph_ms(launch,
                                                      COPIES_ITERS))
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
