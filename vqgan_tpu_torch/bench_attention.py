"""Microbenchmark: the hand-written flash-attention kernels against the
plain einsum version and PyTorch's fused attention, forward and forward +
backward.

    python3 -m vqgan_tpu_torch.bench_attention [--seq 1024 4096] [--dim 64]

Counterpart of cli/bench_attention.py, with its flags and defaults: q, k,
v [batch 8, S, heads 8, dim 64] in bf16 (`--bf16`, on by default, as in
the JAX CLI) from `SEED`, for each `--seq`. Rows, per S and pass:
- "einsum": `sdpa_reference`, the plain version (the JAX CLI's
  "xla-einsum");
- "flash": `flash_attention`, the kernels (csrc/flash_fwd.cu;
  flash_bwd_dq.cu and flash_bwd_dkv.cu in the backward);
- "sdpa": `torch.nn.functional.scaled_dot_product_attention`, the library
  call, beside them as a yardstick; the port never routes to it.
The `--iters` calls of a row are chained by a data dependency, as the JAX
CLI's `fori_loop` chains them: q <- q + out x 1e-3 (forward), q <- q +
dQ x 1e-6 (forward + backward, the gradient of sum(out^2) with respect to q
alone, as in the JAX CLI). One untimed chain first, then one timed chain:
CUDA events around it on the card, so a host slower than the device shows
in the time; the host clock on the CPU. Each row's FLOPs and least bytes
are `utils/flops.count_work` of one call (4 B H S^2 d forward; q, k, v read
and the output written); TFLOP/s, MFU, the tensor-core and HBM bounds and
the share of the larger one the row reached follow from them. The port's
autograd function computes dK and dV even where only q wants a gradient
(`FlashAttentionFunction` runs both backward kernels), so a flash forward
+ backward counts 18 B H S^2 d and launches each kernel once per iteration
("launches_per_iter"); the einsum backward with respect to q alone counts
8 B H S^2 d. Prints one JSON line per row, then the card's name and power
limit (nvidia-smi) or "cpu".

Runs on the GPU by default (`--device cpu` to run on the CPU, with the
kernels' plain versions in place of the kernels).
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.nn.functional as F

from .bench_sampling import device_line
from .device import resolve_device, set_full_fp32_precision
from .kernels import KERNELS
from .ops.attention import flash_attention, sdpa_reference
from .utils.flops import count_work, flops_report, roofline

__all__ = ["main", "parse_args", "chain_ms", "bound_fields", "ROUTES"]

SEED = 0  # of q, k and v


def _sdpa_library(q, k, v):
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return out.transpose(1, 2)


# {row name: attention over BSHD q, k, v}
ROUTES = {"einsum": sdpa_reference, "flash": flash_attention,
          "sdpa": _sdpa_library}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--seq", type=int, nargs="+", default=[1024, 4096])
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def forward_body(attn):
    """One chained forward call: q -> (next q, out)."""
    def body(q, k, v):
        out = attn(q, k, v)
        return q + out * 1e-3, out
    return body


def backward_body(attn):
    """One chained forward + backward call, the gradient of sum(out^2)
    with respect to q alone: q -> (next q, dQ)."""
    def body(q, k, v):
        q = q.detach().requires_grad_()
        with torch.enable_grad():
            loss = attn(q, k, v).float().pow(2).sum()
            (dq,) = torch.autograd.grad(loss, q)
        return q.detach() + dq * 1e-6, dq
    return body


def chain_ms(step, x, iters: int) -> float:
    """ms per call of `iters` chained calls x <- step(x)[0] (step returns
    the next input and its output, whose first element is summed), after
    one untimed chain: CUDA events on the card, the host clock on the
    CPU."""
    def chain():
        xc, acc = x, 0.0
        for _ in range(iters):
            xc, out = step(xc)
            acc = acc + out.flatten()[0].float()
        return acc

    chain()
    if x.device.type != "cuda":
        t0 = time.perf_counter()
        chain()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    chain()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_fields(flops, n_bytes, ms: float, dtype: str, device) -> dict:
    """A row's least bytes, its two bounds, which one sets it and the share
    of it the row reached (`utils/flops.roofline`'s keys); the bounds and
    the share are None on the CPU or where a count is 0."""
    rec = roofline("", flops, n_bytes, ms / 1e3, 1, dtype, device)
    return {key: rec.get(key) for key in ("bytes", "t_tensor_core_ms",
                                          "t_hbm_ms", "bound",
                                          "roofline_fraction")}


def main(argv=None) -> list:
    """Run the benchmark; returns the rows (each also printed)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_full_fp32_precision()
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    dt = "bfloat16" if args.bf16 else "float32"
    card = device_line(device)
    rows = []
    for s in args.seq:
        shape = (args.batch, s, args.heads, args.dim)
        gen = torch.Generator(device).manual_seed(SEED)
        q, k, v = (torch.randn(shape, generator=gen, device=device,
                               dtype=dtype) for _ in range(3))
        for pass_name, make in (("fwd", forward_body),
                                ("fwd+bwd", backward_body)):
            for route, attn in ROUTES.items():
                body = make(attn)
                flops, n_bytes = count_work(lambda: body(q, k, v)[1])
                before = {n: kk.launches for n, kk in KERNELS.items()}
                ms = chain_ms(lambda qc: body(qc, k, v), q, args.iters)
                launched = {n: (kk.launches - before[n]) / (2 * args.iters)
                            for n, kk in KERNELS.items()
                            if kk.launches != before[n]}
                row = {"seq": s, "route": route, "pass": pass_name,
                       "shape": list(shape), "dtype": dt, "ms": ms,
                       **flops_report(flops, ms / 1e3, device),
                       **bound_fields(flops, n_bytes, ms, dt, device),
                       "launches_per_iter": launched, "device": card}
                rows.append(row)
                print(json.dumps(row))
    print(card)
    return rows


if __name__ == "__main__":
    main()
