"""Pipeline parallelism (GPipe) over a "stage" mesh axis.

Counterpart of vqgan_tpu/parallel/pp.py: a depth-L stack of identical
blocks, its parameters stacked on a leading depth axis ([L, ...] per
tensor) and split into S contiguous stages, one per rank of the "stage"
axis; microbatches stream through the stages in the GPipe schedule of
M + S - 1 ticks, the bubble (S - 1) / (M + S - 1).

The schedule is JAX's, tick for tick:
- the batch (this rank's rows of the "data" axis, if any) splits into M
  microbatches, which must divide it as in JAX;
- at each tick stage 0 takes the next microbatch and every other stage
  the activation its predecessor sent at the previous tick; activations
  hop stage i -> i + 1 with `batch_isend_irecv` (`ppermute`);
- the bubble ticks feed a copy of the first microbatch, not zeros, so
  every intermediate stays finite (a block whose backward multiplies by
  a data-dependent factor would otherwise turn 0 * inf into NaN);
- the last stage's outputs of ticks S - 1 .. M + S - 2 are the result,
  summed over "stage" (zeros elsewhere) so that every stage holds it.
It has gradients, as JAX's has: `ppermute` is an autograd function whose
backward sends the cotangents back along the reverse permutation, the
final sum's backward hands each stage its cotangent unchanged (every stage
computes the same loss from the same result), and the input's gradient is
summed over "stage" (only stage 0 reads it). Each stage's pieces of the
stacked parameters get the gradients of its own blocks.

Usage:
    mesh = make_pipeline_mesh(stages=4)
    stacked = stack_params([dict(b.named_parameters()) for b in blocks])
    local = shard_stacked_params(stacked, mesh)   # this stage's [L/S, ...]
    y = pipeline_apply(block_fn, local, x, mesh, num_microbatches=8)
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from . import comm
from .mesh import Mesh, named_mesh, tree_map

__all__ = ["make_pipeline_mesh", "stack_params", "shard_stacked_params",
           "pipeline_apply"]


def make_pipeline_mesh(stages: int, data: int = 1, device="cuda") -> Mesh:
    """A ("data", "stage") mesh: the batch over "data", the block stack
    over "stage"."""
    return named_mesh({"data": data, "stage": stages}, device)


def stack_params(param_trees: Sequence[dict]) -> dict:
    """L per-block name -> tensor dicts stacked into one of [L, ...]."""
    return {k: torch.stack([t[k] for t in param_trees])
            for k in param_trees[0]}


def shard_stacked_params(stacked: dict, mesh: Mesh,
                         axis: str = "stage") -> dict:
    """This stage's blocks of a stacked dict: [L/S, ...] per tensor (views,
    so a gradient reaches the tensors that were stacked)."""
    n, i = mesh.shape[axis], mesh.coord(axis)
    out = {}
    for k, v in stacked.items():
        assert v.shape[0] % n == 0, (
            f"depth {v.shape[0]} must divide over {n} stages")
        out[k] = v.chunk(n, dim=0)[i]
    return out


class _PPermute(torch.autograd.Function):
    """`lax.ppermute` with its transpose as the backward."""

    @staticmethod
    def forward(ctx, group, perm, *xs):
        ctx.group, ctx.back = group, [(j, i) for i, j in perm]
        return tuple(comm.ppermute(list(xs), perm, group))

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros_like(g) if g is None else g for g in gs]
        return (None, None, *comm.ppermute(gs, ctx.back, ctx.group))


class _SumOverStages(torch.autograd.Function):
    """Forward: the sum over the group; backward: the cotangent as it is
    (each stage computes the same downstream from the same sum)."""

    @staticmethod
    def forward(ctx, group, x):
        return comm.all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _FromAllStages(torch.autograd.Function):
    """Forward: the input as it is; backward: the cotangents summed over
    the group (only stage 0 reads the input)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return None, comm.all_reduce_(g.contiguous().clone(), ctx.group)


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _rebuild(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def pipeline_apply(block_fn: Callable[[dict, Any], Any],
                   stacked_params: dict, x: Any, mesh: Mesh, *,
                   num_microbatches: int, axis: str = "stage",
                   data_axis: Optional[str] = "data") -> Any:
    """Run the uniform stack over x with an S-stage GPipe pipeline.

    `stacked_params`: this stage's blocks ([L/S, ...] per tensor, from
    `shard_stacked_params`). `x`: a [B, ...] tensor or a tuple/list/dict
    of them, batch first (e.g. (tokens, cond), so per-example conditioning
    rides with the activations); this rank's rows when the mesh has a
    "data" axis larger than 1. `block_fn(params_i, x) -> x` keeps x's
    structure and shapes. Returns x's structure, the same on every stage;
    equals running all L blocks in order (same math, same order)."""
    S = mesh.shape[axis]
    M = num_microbatches
    idx = mesh.coord(axis)
    dp = (mesh.shape[data_axis]
          if data_axis is not None and data_axis in mesh.shape else 1)
    group = mesh.group(axis) if mesh.distributed else None
    leaves = _leaves(x)
    B = leaves[0].shape[0] * dp
    assert B % (M * dp) == 0, (
        f"batch {B} must divide into {M} microbatches x {dp} data shards")
    depth = next(iter(stacked_params.values())).shape[0]
    if S > 1 and torch.is_grad_enabled() and any(
            t.requires_grad for t in leaves):
        leaves = [_FromAllStages.apply(group, t) for t in leaves]

    mb = [t.reshape((M, t.shape[0] // M) + tuple(t.shape[1:]))
          for t in leaves]
    # bubble ticks feed a copy of the first microbatch
    ticks = [torch.cat([t, t[:1].expand((S - 1,) + tuple(t.shape[1:]))])
             for t in mb]
    first = torch.tensor(idx == 0, device=leaves[0].device)

    def stage_body(h):
        for i in range(depth):
            h = block_fn({k: v[i] for k, v in stacked_params.items()}, h)
        return h

    recv = [t[0] for t in mb]  # first microbatch again, as in JAX
    fwd_perm = [(i, i + 1) for i in range(S - 1)]
    outs = []
    for tick in range(M + S - 1):
        inp = [torch.where(first, m[tick], r) for m, r in zip(ticks, recv)]
        out = _leaves(stage_body(_rebuild(x, inp)))
        outs.append(out)
        if S > 1 and tick < M + S - 2:
            recv = list(_PPermute.apply(group, fwd_perm, *out))
    last = torch.tensor(idx == S - 1, device=leaves[0].device)
    result = []
    for j, t in enumerate(leaves):
        v = torch.stack([o[j] for o in outs[S - 1:S - 1 + M]]).reshape(
            t.shape)
        v = torch.where(last, v, torch.zeros_like(v))
        if S > 1:
            v = _SumOverStages.apply(group, v)
        result.append(v)
    return _rebuild(x, result)
