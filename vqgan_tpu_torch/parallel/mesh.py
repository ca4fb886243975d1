"""The device mesh and the batch's placement on it.

Counterpart of vqgan_tpu/parallel/mesh.py. A `Mesh` names the axes of the
process grid with the JAX package's names ("data", "model", "stage",
"seq"), row-major over the ranks as JAX reshapes its device list: rank r of
a (data, model) mesh sits at data r // model, model r % model. Under a
process group it wraps `torch.distributed.device_mesh.init_device_mesh`
and hands out each axis's process group; in a single process with no
group it is a mesh of one rank whose collectives are no-ops.

A placement is written as the JAX package writes a PartitionSpec, one
entry per tensor dimension: an axis name or None; () replicates.
`placements` turns one into DTensor placements.

  jax.sharding.Mesh                 -> Mesh (make_mesh, make_mesh_for_batch)
  serving's _default_mesh_like      -> mesh_like (an artifact's recorded
                                       axes over the process group)
  NamedSharding(mesh, P("data"))    -> data_sharding(mesh) == ("data",)
  NamedSharding(mesh, P())          -> replicated(mesh) == ()
  device_put(batch, P("data"))      -> shard_batch: this rank's rows
  replicate(tree)                   -> every rank takes rank 0's values
  jax.process_index() == 0          -> is_main_process()

The global batch. JAX jits one program over a batch placed P("data"):
every reduction over the batch axis in it (a BatchNorm mean, a random
draw of the batch's shape, an assignment over the whole batch) is over
the global batch. Here each rank runs its rows, and a trainer's step runs
its forward inside `global_batch(mesh)`, where
- `draw_rows(draw, shape)` draws for the global batch, from a generator
  that every rank holds in the same state, in the single-device order,
  and keeps this rank's rows: every rank draws what one device would
  (`global_shape(shape)` is the shape of the whole draw);
- `sum_over_data(x)` sums over the "data" ranks (and so does the
  gradient: each rank's cotangent is of its own share of the loss);
- `gather_rows(x)` gives every rank's rows (no gradient), and
  `own_rows(x)` this rank's rows of a tensor of the global batch.
Outside the block, or where "data" has one rank, each is the plain
single-device operation, bit for bit. The block is a context, as
`torch.no_grad` is, so that the models and the diffusion library take no
mesh argument: only the trainers' steps know the mesh.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import comm
from .init import process_count

__all__ = ["Mesh", "make_mesh", "make_mesh_for_batch", "mesh_like",
           "data_sharding",
           "replicated", "shard_batch", "replicate", "replicate_module",
           "is_main_process", "placements", "local_rows", "tree_map",
           "global_batch", "batch_mesh", "draw_rows", "gather_rows",
           "global_shape", "own_rows", "sum_over_data", "mean_over_data"]


def tree_map(fn: Callable, tree: Any) -> Any:
    """`fn` over the leaves of a tuple / list / dict tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


class Mesh:
    """Named axes over the ranks. `shape` maps each axis name to its size
    (in order); `device` is where this rank's tensors live."""

    def __init__(self, shape: Dict[str, int], device,
                 device_mesh=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.device = torch.device(device)
        self.device_mesh = device_mesh
        self.size = int(np.prod(list(self.shape.values()), dtype=np.int64))

    def group(self, axis: str):
        """The process group of `axis` (None in a process with no group)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def coord(self, axis: str) -> int:
        """This rank's index along `axis`."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    @property
    def distributed(self) -> bool:
        return self.device_mesh is not None

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def _mesh_device_type(device: torch.device) -> str:
    # the mesh's groups take the default group's backend: NCCL meshes are
    # "cuda" meshes; gloo ones are "cpu" meshes even where the tensors are
    # CUDA tensors (several ranks on one card)
    if device.type == "cuda" and dist.get_backend() == "nccl":
        return "cuda"
    return "cpu"


def named_mesh(shape: Dict[str, int], device="cuda") -> Mesh:
    """A mesh of the given named axes over every rank of the default
    group (or, with no group, over the one process)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    n = int(np.prod(list(shape.values()), dtype=np.int64))
    world = process_count()
    if n != world:
        raise ValueError(f"mesh {dict(shape)} does not cover {world} "
                         f"processes")
    if not dist.is_initialized():
        return Mesh(shape, device)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(_mesh_device_type(device), tuple(shape.values()),
                          mesh_dim_names=tuple(shape))
    return Mesh(shape, device, dm)


def make_mesh(data: Optional[int] = None, model: int = 1,
              device="cuda") -> Mesh:
    """A ("data", "model") mesh; every rank on "data" by default."""
    n = process_count()
    if data is None:
        data = n // model
    assert data * model == n, f"mesh {data}x{model} does not cover {n} devices"
    return named_mesh({"data": data, "model": model}, device)


def make_mesh_for_batch(batch_size: int, model: int = 1,
                        device="cuda") -> Mesh:
    """The mesh whose "data" axis is the largest rank count that divides
    the global batch, as in JAX. JAX leaves the other devices idle; a
    process cannot sit out of its group's collectives, so here the rule
    must reach every rank, or this raises."""
    n = process_count() // model
    data = next(d for d in range(n, 0, -1) if batch_size % d == 0)
    if data != n:
        raise ValueError(f"the global batch {batch_size} does not divide "
                         f"over {n} data-parallel ranks")
    return make_mesh(data=data, model=model, device=device)


def mesh_like(layout: Dict[str, Any], device="cuda") -> Mesh:
    """The mesh of an exported artifact's recorded layout (meta.json's
    {"axes", "shape", "nr_devices"}, e.g. ("data", "model") in JAX's
    order) over every rank of the default group, as the JAX package's
    loader builds one over its first devices; its axes' groups (`group`,
    `coord`) are the serving ranks' ("data": whose rows, "model": whose
    pieces of the split weights)."""
    shape = dict(zip(layout["axes"], layout["shape"]))
    n = int(np.prod(list(shape.values()), dtype=np.int64))
    if n != layout.get("nr_devices", n):
        raise ValueError(f"layout {layout}: its shape covers {n} ranks")
    return named_mesh(shape, device)


def data_sharding(mesh: Mesh, ndim: Optional[int] = None) -> tuple:
    """The batch's placement: the leading dimension over "data"."""
    if ndim is None:
        return ("data",)
    assert ndim >= 1, "batch sharding needs at least a batch dimension"
    return ("data",) + (None,) * (ndim - 1)


def replicated(mesh: Mesh) -> tuple:
    return ()


def placements(spec: Sequence[Optional[str]], mesh: Mesh) -> list:
    """DTensor placements of `spec` on `mesh`: Shard(dim) for each mesh
    axis that a tensor dimension is split over, Replicate() otherwise."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.axis_names:
        dims = [d for d, a in enumerate(spec) if a == axis]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def local_rows(x, mesh: Mesh, axis: str = "data"):
    """The rows of `x` (leading dimension) that this rank holds when `x`
    is split over `axis`."""
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not divide over {n} "
                         f"'{axis}' ranks")
    m = x.shape[0] // n
    i = mesh.coord(axis)
    return x[i * m:(i + 1) * m]


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of a host batch that every rank holds whole, on
    the mesh's device (the leading axis split over "data")."""
    def put(x):
        x = torch.as_tensor(x) if not torch.is_tensor(x) else x
        return local_rows(x, mesh).to(mesh.device)

    return tree_map(put, batch)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """The tree on the mesh's device with rank 0's values on every rank."""
    def put(x):
        x = (torch.as_tensor(x) if not torch.is_tensor(x) else x).to(
            mesh.device, copy=True)
        if mesh.distributed:
            comm.broadcast_(x, 0, None)
        return x

    return tree_map(put, tree)


@torch.no_grad()
def replicate_module(module: torch.nn.Module, mesh: Mesh) -> None:
    """Every parameter and buffer of `module`, in place, with rank 0's
    values on every rank."""
    if mesh.distributed:
        for t in (*module.parameters(), *module.buffers()):
            comm.broadcast_(t.data, 0, None)


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


_GLOBAL_BATCH: List[Mesh] = []


@contextlib.contextmanager
def global_batch(mesh: Optional[Mesh]):
    """Inside the block the batch axis spans `mesh`'s "data" ranks (see
    the module docstring); None leaves it this rank's."""
    _GLOBAL_BATCH.append(mesh)
    try:
        yield
    finally:
        _GLOBAL_BATCH.pop()


def batch_mesh() -> Optional[Mesh]:
    """The mesh of the innermost `global_batch` block where its "data"
    axis has more than one rank; None otherwise."""
    mesh = _GLOBAL_BATCH[-1] if _GLOBAL_BATCH else None
    if mesh is None or not mesh.distributed or mesh.shape["data"] == 1:
        return None
    return mesh


def own_rows(x: torch.Tensor) -> torch.Tensor:
    """Inside `global_batch`, this rank's rows of `x`, a tensor of the
    global batch; `x` otherwise."""
    mesh = batch_mesh()
    return x if mesh is None else local_rows(x, mesh)


def global_shape(shape: Sequence[int]) -> tuple:
    """Inside `global_batch`, the shape of the global batch's tensor of
    which a rank holds rows of `shape`; `shape` otherwise."""
    mesh = batch_mesh()
    n = 1 if mesh is None else mesh.shape["data"]
    return (shape[0] * n, *shape[1:])


def draw_rows(draw: Callable, shape: Sequence[int]) -> torch.Tensor:
    """draw(shape), a random tensor whose leading axis is the batch (this
    rank's shape[0] rows); inside `global_batch`, this rank's rows of
    draw(the global batch's shape)."""
    return own_rows(draw(global_shape(shape)))


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Inside `global_batch`, every "data" rank's rows of `x` in rank
    order (no gradient); `x` otherwise."""
    mesh = batch_mesh()
    if mesh is None:
        return x
    return comm.all_gather_cat(x.detach(), 0, mesh.group("data"))


class _SumOverData(torch.autograd.Function):
    """The sum over the group; the backward sums the cotangents over it
    too, since each rank's cotangent is of its own share of the loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return comm.all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce_(g.contiguous().clone(), ctx.group), None


def sum_over_data(x: torch.Tensor) -> torch.Tensor:
    """Inside `global_batch`, `x` summed over the "data" ranks, with its
    gradient; `x` otherwise."""
    mesh = batch_mesh()
    if mesh is None:
        return x
    return _SumOverData.apply(x, mesh.group("data"))


@torch.no_grad()
def mean_over_data(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]
                   ) -> list:
    """Each tensor averaged over `mesh`'s "data" ranks, in one flat fp32
    all-reduce, each in its own dtype again: the gradients and the logs
    of a step over the global batch. The tensors themselves where "data"
    has one rank or there is no group (a one-rank group still runs its
    collective, whose sum is the tensor itself)."""
    tensors = list(tensors)
    if mesh is None or not mesh.distributed or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    comm.all_reduce_(flat, mesh.group("data"))
    n = mesh.shape["data"]
    if n > 1:
        flat.div_(float(n))
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t).to(t.dtype))
        i += t.numel()
    return out
