"""Run a function on N ranks of a fresh process group, with a deadline.

`spawn(fn, n, args)` starts n processes (`torch.multiprocessing`, start
method "spawn"), joins them into one process group over
`tcp://127.0.0.1:<free port>` (gloo by default, NCCL with
backend="nccl"), calls `fn(rank, world, *args)` on each, and returns each
rank's return value in rank order. A rank that raises fails the call with
its traceback; a run that outlives `timeout` seconds (a collective that
never completes) is killed and raises TimeoutError. torchrun is the other
way in: the entry points call `init.initialize_distributed()`, which reads
its environment.
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile
import time
from pathlib import Path
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["spawn", "free_port"]


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, fn, world, port, backend, device, threads, out, timeout,
           args):
    torch.set_num_threads(threads)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    # a collective that outlives this reports itself (NCCL's watchdog names
    # the operation) before the deadline kills the ranks
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        result = fn(rank, world, *args)
        torch.save(result, Path(out) / f"{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: Sequence = (), *,
          timeout: float = 120.0, backend: str = "gloo", device="cpu",
          threads: int = 1) -> list:
    """fn(rank, world, *args) on `nprocs` ranks; their results in rank
    order. `fn` must be importable by name (a module-level function);
    `threads` is each rank's torch thread count."""
    with tempfile.TemporaryDirectory() as out:
        ctx = mp.start_processes(
            _entry, args=(fn, nprocs, free_port(), backend, str(device),
                          threads, out, 0.8 * timeout, tuple(args)),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{getattr(fn, '__name__', fn)} on {nprocs} ranks "
                        f"did not finish within {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(out, f"{r}.pt"), weights_only=False)
                for r in range(nprocs)]
