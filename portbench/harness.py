"""What every cell's run shares: the run's context, the measured windows,
the result line and the checks that close a run.

A driver (`drivers/<name>.py`) gets a `Context` and returns a `Record`:
the host clock's readings, the program's counters, the traced sub-window
(`--trace 1`), the work counted on the reference, the checks (each number
compared with its limit) and the device's memory peak. The metric readers
(`metrics/<name>.py`) take their numbers from the record.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vqgan_tpu")

__all__ = ["Context", "Record", "Check", "train_window", "forbidden_modules",
           "seed_for", "free_device", "stderr", "mark"]


def stderr(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def mark(ctx: "Context", what: str) -> None:
    """Note on standard error when a stage of set-up ended, in seconds
    since the process started: where set-up's time goes."""
    stderr(f"[portbench] {what} at {time.perf_counter() - ctx.started:.3f} s")


def seed_for(seed: int, purpose: str) -> int:
    """A 63-bit seed for one use of the run's seed (weights, inputs, the
    program's generator), so that the uses draw independent streams and
    any seed up to and past 2**32 is taken whole."""
    import hashlib

    digest = hashlib.sha256(f"{seed}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@dataclasses.dataclass
class Context:
    """One run: its arguments, the cell's and the configuration's files,
    the process's start on the host clock and a scratch directory under
    TMPDIR that the run removes."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    cell: dict
    config: dict
    started: float
    scratch: Path = None

    def __post_init__(self):
        if self.scratch is None:
            self.scratch = Path(tempfile.mkdtemp(prefix="portbench-"))

    @property
    def traffic(self) -> dict:
        return self.cell["traffic_params"]


@dataclasses.dataclass
class Check:
    """A number compared with its limit: correct while value <= limit."""

    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Record:
    """What a driver hands back. `host`: the host clock's readings
    (setup_s, window_s, and the counts of the window's work); `counters`:
    the program's own counters; `device_kind`: the card's name
    (`torch.cuda.get_device_name`); `trace`: the traced sub-window or None;
    `work`: FLOPs counted on the reference; `checks`: {name: Check};
    `notes`: every number the run read, compared or not, as (value,
    where it was found: a leaf's name, a request)."""

    host: dict
    counters: dict
    attempted: int
    failed: int
    checks: Dict[str, Check]
    memory_peak_bytes: int
    chips: int
    device_kind: str = "cpu"
    trace: Optional[dict] = None
    work: dict = dataclasses.field(default_factory=dict)
    notes: dict = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return (self.attempted > 0 and self.failed == 0
                and all(c.ok for c in self.checks.values()))


def train_window(seconds: float, dispatch: Callable[[], object],
                 read: Callable[[object], int], sync: Callable[[], None]
                 ) -> dict:
    """Dispatch blocks until `seconds` have passed on the host clock, each
    block's losses read one dispatch late (the trainers' rule), then wait
    for the device. `dispatch()` queues one block and returns its pending
    losses; `read(pending)` reads them on the host and returns how many
    were not finite. Returns {"window_s", "blocks", "failed"}: the window
    runs from a synchronised device to the end of the last block."""
    sync()
    start = time.perf_counter()
    pending, blocks, failed = None, 0, 0
    while True:
        current = dispatch()
        blocks += 1
        if pending is not None:
            failed += read(pending)
        pending = current
        if time.perf_counter() - start >= seconds:
            break
    failed += read(pending)
    sync()
    return {"window_s": time.perf_counter() - start, "blocks": blocks,
            "failed": failed}


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's (compared whole: the port's name
    begins with the JAX package's)."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def free_device() -> None:
    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())
