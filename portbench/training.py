"""The run of a training cell, shared by its drivers: set-up drives the
trainer's own block call and feed through the first steps (the reference
follows the first three), the window dispatches full blocks, a traced
sub-window follows with `--trace 1`, then the program is freed and the
reference checks the first steps.

A driver supplies a `Trainee`: how to dispatch a block of device
batches, which losses a block returns, the optimizer's view of the first
gradient and the trained leaves, by name.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import torch

from . import tracing
from .harness import Context, free_device, mark, train_window

__all__ = ["Trainee", "run_training"]

CHECKED = 3  # steps the reference follows


class Trainee:
    """What the shared run needs of one trainer.

    - `batches`: the trainer's feed, `device_prefetch` over the host
      batches: (host batch, device batch) pairs;
    - `dispatch(drawn)`: one block of len(drawn) steps through the
      trainer's window call; returns its logs (stacked on [K]);
    - `losses(logs)`: {name: [K] tensor} of the losses compared;
    - `fed_grads()`: {leaf: the gradient the optimizer was fed}, from its
      state after one step; `leaves()`: {leaf: value};
    - `step_codes()`: after each of the first `CHECKED` steps, the
      discrete choices the step made, which the reference follows and
      judges (the VQ-GAN's codes), or None where the step makes none;
    - `close()`: stop the feed and drop the trainer."""

    batches = None
    batch = 0

    def dispatch(self, drawn):
        raise NotImplementedError

    def losses(self, logs) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def fed_grads(self) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def leaves(self) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def step_codes(self):
        return None

    def graph_capture_s(self) -> float:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


def _nonfinite(losses: Dict[str, torch.Tensor]) -> int:
    bad = 0
    for v in losses.values():
        bad = max(bad, int((~torch.isfinite(v.float().cpu())).sum()))
    return bad


def run_training(ctx: Context, trainee: Trainee, sync: Callable[[], None],
                 block: int, global_batch: int) -> dict:
    """Set-up's first steps, the window and, with ctx.trace, the traced
    sub-window. Returns {"host", "first", "trace", "memory_peak_bytes",
    "graph_capture_s", "attempted", "failed", "device_kind"}. "first"
    holds the program's readings of the first `CHECKED` steps: their
    losses, the fed gradient of step 1 and the leaves after step 3
    (copies on the device), the host batches they ran on and, where the
    steps make them, each step's codes (`Trainee.step_codes`). Each of
    those steps is a dispatch of its own, so that its codes can be read
    before the next."""
    waits: List[float] = []

    def draw(n):
        with tracing.span("input"):
            t = time.perf_counter()
            drawn = [next(trainee.batches) for _ in range(n)]
            waits.append(time.perf_counter() - t)
        return drawn

    def dispatch(n):
        drawn = draw(n)
        with tracing.span("dispatch"):
            return drawn, trainee.dispatch(drawn)

    first = {"losses": {}, "host": []}

    def keep(drawn, logs):
        for name, v in trainee.losses(logs).items():
            first["losses"].setdefault(name, []).extend(
                float(x) for x in v.float().cpu())
        first["host"].extend(d[0] for d in drawn)
        first.setdefault("codes", []).append(trainee.step_codes())

    mark(ctx, "program built")
    keep(*dispatch(1))  # step 1: the eager warm-up of the step's graph
    first["grads"] = {k: v.clone() for k, v in trainee.fed_grads().items()}
    mark(ctx, "step 1 (eager)")
    for _ in range(CHECKED - 1):  # step 2 captures, step 3 replays
        keep(*dispatch(1))
    first["leaves"] = {k: v.detach().clone()
                       for k, v in trainee.leaves().items()}
    mark(ctx, "steps 2-3 (capture, replay)")
    _, logs = dispatch(block)  # the window's block shape, once
    failed = _nonfinite(trainee.losses(logs))
    sync()
    setup_s = time.perf_counter() - ctx.started
    mark(ctx, "set-up")

    waits.clear()
    window = train_window(
        ctx.seconds, lambda: trainee.losses(dispatch(block)[1]), _nonfinite,
        sync)
    steps = window["blocks"] * block
    host = {"setup_s": setup_s, "window_s": window["window_s"],
            "steps": steps, "samples": steps * global_batch,
            "input_wait_s": sum(waits), "global_batch": global_batch}
    trace = None
    if ctx.trace:
        def sub():
            n = ctx.traffic["trace_blocks"]
            pending = None
            for _ in range(n):
                pending = trainee.losses(dispatch(block)[1])
            _nonfinite(pending)
            return {"steps": n * block, "samples": n * block * global_batch}

        trace = tracing.traced(sub)
    out = {"host": host, "first": first, "trace": trace,
           "memory_peak_bytes": torch.cuda.max_memory_allocated()
           if torch.cuda.is_available() else 0,
           "graph_capture_s": trainee.graph_capture_s(),
           "device_kind": torch.cuda.get_device_name()
           if torch.cuda.is_available() else "cpu",
           "attempted": steps, "failed": failed + window["failed"]}
    trainee.close()
    if torch.cuda.is_available():
        free_device()
    return out
