"""Device input prefetching: overlap the host-to-device copy with compute.

Counterpart of vqgan_tpu/data/prefetch.py. `jax.device_put` only enqueues
its copy; the PyTorch idiom for the same is a copy from pinned host memory
with `non_blocking=True` (`to_device`), enqueued on the trainer's stream
behind the step already queued there, so the host never waits for the
device to drain before it launches the next step. `device_prefetch` keeps
`depth` batches enqueued ahead of the consumer.

Yields (host_item, device_item) pairs: the trainers feed the device
version to the step and keep the host version for host-side uses (grids).
The deque holds each pair until the consumer takes it. The pinned staging
buffer of a copy comes from PyTorch's caching host allocator, which records
the copy's event on it and hands the buffer out again only after that
event, so it is never written while its copy may still read it.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

__all__ = ["device_prefetch", "to_device"]


def device_prefetch(iterator: Iterable, put: Callable[[Any], Any],
                    depth: int = 2) -> Iterator[Tuple[Any, Any]]:
    """Wrap a host batch iterator so that copies run `depth` batches ahead.

    put: host batch -> device tensors (`to_device`); called on up to
    `depth` batches before the consumer asks for them. Closing the
    generator closes `iterator` too."""
    if depth < 1:
        raise ValueError(f"depth must be at least 1, got {depth}")
    it = iter(iterator)
    q: deque = deque()
    exhausted = False
    try:
        while True:
            while not exhausted and len(q) < depth:
                try:
                    item = next(it)
                except StopIteration:
                    exhausted = True
                    break
                q.append((item, put(item)))
            if not q:
                return
            yield q.popleft()
    finally:  # closing the prefetcher closes the loader (stops its thread)
        close = getattr(it, "close", None)
        if close is not None:
            close()


def to_device(array: np.ndarray, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`array` (as `dtype`) on `device`: on the GPU a copy from a pinned
    host tensor with `non_blocking=True` on the current stream; on the CPU
    the host tensor itself, as `.to("cpu")` returns it."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    if dtype is not None:
        host = host.to(dtype)
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)
