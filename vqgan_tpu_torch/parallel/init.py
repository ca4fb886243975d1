"""Process-group initialisation and the global batch's per-rank slices.

Counterpart of vqgan_tpu/parallel/init.py. The JAX package runs one
process per host and a mesh over every chip; the port runs one process per
GPU (torchrun), so a process is one device of the mesh:

  jax.distributed.initialize       -> initialize_distributed()
                                      (torch.distributed: NCCL on CUDA,
                                      gloo on the CPU)
  process_local_batch_size         -> the same rule: equal contiguous shares
  make_global_array                -> each rank keeps the rows of the global
                                      batch that JAX's process holds
  barrier                          -> torch.distributed.barrier

A run with no launcher (no WORLD_SIZE in the environment and no arguments)
is one process and initialises nothing; every function below then acts on
a world of one.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch
import torch.distributed as dist

__all__ = ["initialize_distributed", "process_count", "process_index",
           "process_local_batch_size", "make_global_array", "barrier",
           "default_backend"]


def default_backend(device) -> str:
    """NCCL for CUDA ranks, gloo for CPU ranks."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(device="cuda", backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> int:
    """Join the process group that torchrun's environment (or the
    arguments) describe; returns this process's rank.

    `backend` defaults to NCCL on CUDA and gloo on the CPU. On CUDA the
    rank takes the card LOCAL_RANK % device_count. Idempotent; with no
    launcher and no arguments, a no-op that returns 0."""
    if dist.is_initialized():
        return dist.get_rank()
    device = torch.device(device)
    if world_size is None and "WORLD_SIZE" not in os.environ:
        return 0
    backend = backend or default_backend(device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    given = {k: v for k, v in (("world_size", world_size), ("rank", rank))
             if v is not None}  # else torchrun's environment says
    dist.init_process_group(backend, init_method=init_method or "env://",
                            **given)
    return dist.get_rank()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_local_batch_size(global_batch_size: int) -> int:
    """The share of the global batch that this process loads: equal
    contiguous shares, as the reference's DistributedSampler."""
    n = process_count()
    assert global_batch_size % n == 0, (
        f"global batch {global_batch_size} must divide over {n} processes")
    return global_batch_size // n


def make_global_array(local_batch: Any, mesh, spec=("data",)) -> Any:
    """This rank's share of a global batch to which every process
    contributes its own rows: the rows that JAX's `make_global_array`
    leaves on this process's device. `local_batch` (a tensor or array, or
    a tuple, list or dict of them) is the share this process loaded; it
    goes to the mesh's device as it is. `spec` names the mesh axes the
    batch is split over, as in JAX; the rows of the other axes' ranks
    repeat."""
    from .mesh import tree_map

    del spec  # each rank already holds its rows
    return tree_map(lambda x: torch.as_tensor(x).to(mesh.device), local_batch)


def barrier(name: str = "barrier") -> None:
    """Block until every process reaches this point (the reference's
    `accelerator.wait_for_everyone`)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
