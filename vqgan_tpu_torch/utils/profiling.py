"""Tracing and step-timing hooks.

Counterpart of vqgan_tpu/utils/profiling.py:

- `trace(log_dir)`: a `torch.profiler` trace of the block (CPU and, on the
  card, CUDA activity), written as a Chrome / TensorBoard trace
  (`trace.json`) into `log_dir`;
- `annotate(name)`: a named region inside a trace
  (`torch.profiler.record_function`);
- `StepTimer`: per-step host time with a warm-up excluded and an EMA;
  `step(sync)` synchronises the device first, where the JAX package calls
  `block_until_ready`.

Keep `trace` out of every timed loop: once torch.profiler has run in a
process, every later kernel launch of that process costs more host time
(PERF.md, "Repaired"), so profile in a process of its own.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace", "StepTimer", "annotate"]

annotate = record_function  # a named region inside a trace


@contextlib.contextmanager
def trace(log_dir: str | Path = "./profile"):
    """Profile the block; write `log_dir/trace.json` (chrome://tracing,
    Perfetto or TensorBoard's trace viewer) and yield the profiler, whose
    `key_averages()` sums the time by operator and kernel:

        with trace("./profile"):
            for _ in range(10):
                train_step(state, batch)
    """
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


class StepTimer:
    """Step timing with a warm-up excluded and EMA smoothing.

    step(sync) synchronises the device where `sync` is True, or is a CUDA
    tensor (the step's output) or a device, so that a time covers the
    device's work and not only its enqueue."""

    def __init__(self, warmup: int = 2, ema: float = 0.9):
        self.warmup = warmup
        self.ema = ema
        self._count = 0
        self._avg: Optional[float] = None
        self._last = time.perf_counter()

    def step(self, sync=None) -> Optional[float]:
        """Seconds since the previous call (None within the warm-up)."""
        if isinstance(sync, torch.Tensor):
            sync = sync.device if sync.is_cuda else None
        elif sync is True:
            sync = torch.device("cuda") if torch.cuda.is_available() else None
        if isinstance(sync, torch.device) and sync.type == "cuda":
            torch.cuda.synchronize(sync)
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self._count += 1
        if self._count <= self.warmup:
            return None
        self._avg = dt if self._avg is None else (
            self.ema * self._avg + (1 - self.ema) * dt)
        return dt

    @property
    def avg_seconds(self) -> Optional[float]:
        return self._avg

    def throughput(self, items_per_step: int) -> Optional[float]:
        if self._avg is None:
            return None
        return items_per_step / self._avg
