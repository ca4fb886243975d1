"""Arithmetic that several metric readers share. Each reader
(`metrics/<name>.py`) is `read(record) -> number or None`; None when the
run has nothing for it to read, and then the metric is left out of the
result line.
"""

from __future__ import annotations

from typing import Iterable, Optional

from . import work

__all__ = ["kernel_roofline", "device_seconds", "range_device_seconds",
           "idle_pct", "KERNEL_NAMES"]

# the program's kernels as the device trace names them (templated CUDA
# functions: the name is part of the demangled signature)
KERNEL_NAMES = {"flash_fwd": "flash_fwd_kernel",
                "flash_bwd_dq": "flash_bwd_dq_kernel",
                "flash_bwd_dkv": "flash_bwd_dkv_kernel",
                "vq_nearest": "vq_nearest_kernel"}


def _least(kernel: str, shape: tuple, peaks: dict) -> float:
    """Least seconds of one launch at a counted shape: attention shapes
    are (B, S, heads, d, dtype), self-attention (keys = queries, as every
    attention of the measured models is); VQ shapes (N, K, D, mode)."""
    if kernel == "vq_nearest":
        n, k, d, mode = shape
        n_bytes, flops = work.vq_work(n, k, d)
        dtype = "float32" if mode == "fp32" else "bfloat16"
    else:
        b, s, h, d, dtype = shape
        item = work.ITEMSIZE[dtype]
        if kernel == "flash_fwd":
            n_bytes, flops = work.flash_fwd_work(b, s, s, h, d, item)
        else:
            n_bytes, flops = work.backward_work(b, s, s, h, d, item)[kernel]
    return work.least_seconds(peaks, n_bytes, flops, dtype)


def device_seconds(trace: dict, needle: str) -> tuple:
    """(seconds, events) of the traced device activity whose name holds
    `needle`."""
    hits = [(e - s) for name, s, e in trace["device"] if needle in name]
    return sum(hits) / 1e6, len(hits)


def kernel_roofline(record, kernels: Iterable[str]) -> Optional[float]:
    """The kernels' share of their roofline in the traced sub-window, in
    %: the least time of every launch the program counted there (frozen
    formulas at the counted shapes) over the kernels' traced device time.
    None where they did not run, or where the trace and the counters
    disagree on the number of launches."""
    trace = record.trace
    if not trace:
        return None
    counted, seconds, events = 0, 0.0, 0
    for kernel in kernels:
        counted += sum(trace["launches"].get(kernel, {}).values())
        s, e = device_seconds(trace, KERNEL_NAMES[kernel])
        seconds, events = seconds + s, events + e
    if not counted or not seconds or events != counted:
        return None
    peaks = work.peaks_for(trace["device_name"])
    least = sum(n * _least(kernel, tuple(shape), peaks)
                for kernel in kernels
                for shape, n in trace["launches"].get(kernel, {}).items())
    return 100.0 * least / seconds


def range_device_seconds(trace: dict, name: str) -> Optional[float]:
    """Device seconds inside the benchmark's host ranges called `name`
    (those that end with the device synchronised), the union of the
    device's intervals clipped to each range."""
    spans = trace["ranges"].get(f"portbench.{name}")
    if not spans:
        return None
    intervals = [(s, e) for _, s, e in trace["device"]]
    return sum(work.union_seconds(intervals, lo, hi)
               for lo, hi in spans) / 1e6


def idle_pct(record) -> Optional[float]:
    trace = record.trace
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
