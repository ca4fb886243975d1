"""The traced sub-window: `torch.profiler` over a bounded stretch of the
cell's work after the measured window, reduced in memory (nothing is
written to disk) to what the metric readers and the result's breakdown
read: the device's activity intervals, the benchmark's own host ranges,
busy and idle time, the kernels that took the most time and the longest
idle gaps, each named by what the host was doing.

Host ranges are `torch.profiler.record_function` spans named
"portbench.<what>" around the benchmark's calls into the program.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Callable

from . import work

__all__ = ["span", "traced", "launch_counts", "launch_delta"]

WINDOW = "portbench.window"


@contextlib.contextmanager
def span(name: str):
    """A host range of the benchmark ("portbench.<name>"): a
    `record_function` span, which costs nothing while no profiler runs."""
    from torch.profiler import record_function

    with record_function(f"portbench.{name}"):
        yield


def launch_counts() -> dict:
    """{kernel: {shape: launches}} of the program's hand-written kernels,
    from their own counters (a graph replay counts what its capture
    recorded)."""
    from vqgan_tpu_torch.kernels import KERNELS

    return {name: dict(k.launches_by_shape) for name, k in KERNELS.items()}


def launch_delta(before: dict, after: dict) -> dict:
    out = {}
    for name, shapes in after.items():
        diff = {s: n - before.get(name, {}).get(s, 0)
                for s, n in shapes.items()}
        diff = {s: n for s, n in diff.items() if n}
        if diff:
            out[name] = diff
    return out


def traced(fn: Callable[[], dict]) -> dict:
    """Run fn() (the sub-window's work, ending with the device synchronised;
    it returns what the readers need beside the trace, such as the steps
    it ran) under the profiler. Returns that dict with "window" (start,
    end in microseconds), "device" [(name, start, end)], "ranges" {name:
    [(start, end)]}, "busy_s", "window_s", "launches", "device_ops" and
    "idle_gaps"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    sync()
    before = launch_counts()
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            info = fn()
            sync()
    launches = launch_delta(before, launch_counts())
    device, host, ranges = [], [], defaultdict(list)
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        user = (getattr(e, "is_user_annotation", False)
                or e.name.startswith("portbench."))
        if e.device_type == DeviceType.CUDA:
            if not user:
                device.append((e.name, start, end))
        elif user:
            ranges[e.name].append((start, end))
        else:
            host.append((e.name, start, end))
    if not ranges[WINDOW]:
        raise RuntimeError("the profiler recorded no window range")
    lo, hi = ranges[WINDOW][0]
    intervals = [(s, e) for _, s, e in device]
    busy = work.union_seconds(intervals, lo, hi) / 1e6
    per_name = defaultdict(float)
    for name, s, e in device:
        per_name[name] += (e - s) / 1e6
    ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(work.idle_gaps(intervals, lo, hi),
                  key=lambda g: g[0] - g[1])[:10]
    return {**info,
            "device_name": torch.cuda.get_device_name() if on_card else "cpu",
            "window": (lo, hi), "device": device,
            "ranges": dict(ranges), "busy_s": busy,
            "window_s": (hi - lo) / 1e6, "launches": launches,
            "device_ops": [[name[:160], s] for name, s in ops],
            "idle_gaps": [[_label(g, ranges, host), (g[1] - g[0]) / 1e6]
                          for g in gaps]}


def _label(gap, ranges: dict, host: list) -> str:
    """What the host was doing at a gap's middle: the innermost of the
    benchmark's ranges that holds it, then the innermost host operation."""
    mid = (gap[0] + gap[1]) / 2

    def innermost(spans):
        best = None
        for name, s, e in spans:
            if s <= mid <= e and (best is None or s >= best[1]):
                best = (name, s)
        return best[0] if best else None

    ours = innermost([(n, s, e) for n, spans in ranges.items()
                      if n != WINDOW for s, e in spans])
    op = innermost(host)
    parts = [p for p in (ours, op) if p]
    return " / ".join(parts) if parts else "host idle"
