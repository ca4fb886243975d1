"""The scan-mode training loop shared by the LDM and VQ-GAN trainers.

Counterpart of the JAX package's scan loops
(vqgan_tpu/training/ldm_trainer.py, vqgan_tpu/training/vqgan_trainer.py):
full blocks of `scan_block` steps run where the next event (a log, a save
with its grid, the end, and any extra cadence such as the VQ-GAN's
revival) is at least a block away, and the steps that lead up to an event
run one at a time. Each dispatch's stacked losses are read one dispatch
late, after the next dispatch is queued; a non-finite loss drains the
dispatch just queued at once.

The port keeps its two repairs of the faults ADVICE.md records in JAX's
scan loop: a save first drains the pending losses, and a cadence of 0
turns its event off.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, Sequence

import numpy as np

from .watchdog import TrainingWatchdog

__all__ = ["capture_seconds", "drain_block_losses", "resolve_step_mode",
           "run_scan_loop"]


def resolve_step_mode(mode: str, num_steps: int, eager: str) -> str:
    """"auto" gives "scan" for runs of 1000 steps or more, where the graph
    captures amortise, and `eager` otherwise, as the JAX CLIs resolve it;
    any other mode is itself."""
    if mode != "auto":
        return mode
    return "scan" if num_steps >= 1000 else eager


def capture_seconds(graph_stats: list) -> float:
    """The capture seconds of `Graphed.stats()` entries, summed."""
    return sum(st["capture_seconds"] or 0.0 for st in graph_stats)


def drain_block_losses(watchdog: TrainingWatchdog, pending,
                       losses: list) -> bool:
    """Read one dispatch's stacked per-step losses (pending = (step after
    the dispatch, losses [n] on the device)), append them to `losses` and
    run the watchdog over each (the third non-finite strike in a row
    raises TrainingDiverged); True when any was non-finite. As the JAX
    package's `_drain_scan_losses`."""
    end, values = pending
    arr = np.asarray(values.float().cpu()).reshape(-1)
    for i, value in enumerate(arr):
        losses.append(float(value))
        for w in watchdog.check(end - len(arr) + 1 + i, float(value)):
            print(f"  [watchdog] {w}")
    return not bool(np.isfinite(arr).all())


def run_scan_loop(*, start: int, num_steps: int, scan_block: int,
                  batches: Iterator, dispatch: Callable,
                  log_every: int, log: Callable,
                  save_every: int, save: Callable,
                  watchdog: TrainingWatchdog, sync: Callable,
                  graph_stats: Callable, timing_warmup: int,
                  cadences: Sequence[int] = ()) -> dict:
    """Train from step `start` up to `num_steps`.

    - dispatch(step, drawn) runs len(drawn) steps from `step` on the
      items `drawn` from `batches` (closed at the end): the trainers pass
      `device_prefetch`'s iterator, so each item is a (host batch, device
      batch) pair and dispatch stacks the device side; it returns
      (stacked logs, stacked losses [n]) and runs whatever the trainer
      does after a block (the VQ-GAN's revival, one of the `cadences`);
    - log(step, logs, per_second) at every `log_every`-th step, with the
      steps per second since the last log;
    - save(milestone) at every `save_every`-th step, after the pending
      losses are drained, and once at the end of a run that ends off that
      cadence (milestone steps // save_every + 1, as the JAX trainers
      number it).

    Returns {"losses": every step's loss, "timed_steps", "timed_seconds"}:
    host seconds from the first dispatch at least `timing_warmup` steps
    in, the device synchronised at both ends, saves and graph captures
    (`graph_stats()`'s capture seconds) excluded."""
    step = start
    losses = []
    pending = None  # (end step, that dispatch's losses on the device)

    def next_event(s: int) -> int:
        return min([num_steps] + [(s // c + 1) * c for c in
                                  (log_every, save_every, *cadences) if c])

    def drain(item) -> bool:
        return drain_block_losses(watchdog, item, losses)

    timed_from = timed_step = None
    timed_seconds = captures = 0.0
    t_log, n_log = time.perf_counter(), 0
    try:
        while step < num_steps:
            if timed_from is None and step - start >= timing_warmup:
                sync()
                timed_from, timed_step = time.perf_counter(), step
                captures = capture_seconds(graph_stats())
            n = scan_block if next_event(step) - step >= scan_block else 1
            logs, block_losses = dispatch(
                step, [next(batches) for _ in range(n)])
            step += n
            n_log += n
            current = (step, block_losses)
            if pending is not None and drain(pending):
                drain(current)
                current = None
            pending = current

            if log_every and step % log_every == 0:
                log(step, logs, n_log / (time.perf_counter() - t_log))
                t_log, n_log = time.perf_counter(), 0

            if save_every and step % save_every == 0:
                if pending is not None:
                    drain(pending)
                    pending = None
                if timed_from is not None:
                    timed_seconds += time.perf_counter() - timed_from
                save(step // save_every)
                if timed_from is not None:
                    timed_from = time.perf_counter()
    finally:
        batches.close()  # stops the loader's thread
    if pending is not None:
        drain(pending)
    sync()
    timed_steps = 0
    if timed_from is not None:
        timed_seconds += time.perf_counter() - timed_from
        timed_seconds -= capture_seconds(graph_stats()) - captures
        timed_steps = num_steps - timed_step
    if num_steps > start and (not save_every or num_steps % save_every):
        save(num_steps // save_every + 1 if save_every else 1)
    return {"losses": losses, "timed_steps": timed_steps,
            "timed_seconds": timed_seconds}
