"""The collectives the scale-out modules use, on NCCL and on gloo alike.

Every function takes a process group (a mesh axis's group, or None for
the default group) and works on tensors of the rank's device. NCCL takes
CUDA tensors; gloo takes CPU tensors, and where it is given CUDA tensors
(several ranks sharing one card) the data goes through host memory. A
group of one rank still calls the backend, so a one-rank NCCL group runs
real NCCL collectives.

Inside a CUDA graph capture (`graphs.Graphed`) a collective is captured
only where NCCL runs it on the card: the kernels NCCL enqueues go onto the
capture stream and replay with the graph. A gloo collective, or one staged
through host memory, would run once at capture and never again, so each
function here raises inside a capture unless its group is NCCL's and its
tensors are on the card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["all_gather_cat", "all_reduce_", "broadcast_", "capturing",
           "group_size", "group_rank", "global_rank", "ppermute",
           "reduce_scatter", "send_recv"]


# newer torch names it reduce_scatter_single (the old name warns)
_reduce_scatter_tensor = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)


def group_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def group_rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def global_rank(group, rank_in_group: int) -> int:
    """The global rank of `rank_in_group` in `group`."""
    if group is None:
        return rank_in_group
    return dist.get_global_rank(group, rank_in_group)


def capturing() -> bool:
    """Whether this thread's current CUDA stream is capturing a graph."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def _via_host(t: torch.Tensor, group) -> bool:
    backend = dist.get_backend(group)
    if capturing() and (backend != "nccl" or not t.is_cuda):
        raise RuntimeError(
            f"a {backend} collective on a {t.device} tensor inside a CUDA "
            f"graph capture would run at capture only; the captured step "
            f"modes need an NCCL process group on the card")
    return t.is_cuda and backend == "gloo"


def all_reduce_(t: torch.Tensor, group=None,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of `t` over `group`."""
    if not dist.is_initialized():
        return t
    if _via_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def broadcast_(t: torch.Tensor, src_in_group: int = 0,
               group=None) -> torch.Tensor:
    """In-place broadcast of `t` from group rank `src_in_group`."""
    if not dist.is_initialized():
        return t
    src = global_rank(group, src_in_group)
    if _via_host(t, group):
        host = t.cpu()
        dist.broadcast(host, src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src, group=group)
    return t


def all_gather_cat(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's `t` (equal shapes), concatenated along `dim` in group
    rank order."""
    n = group_size(group)
    if not dist.is_initialized():
        return t
    src = t.contiguous()
    if _via_host(src, group):
        host = src.cpu()
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts, dim=dim).to(t.device)
    if dist.get_backend(group) == "nccl":
        # one output tensor: NCCL writes it in place, with no staging
        # buffer to copy out of (and none to hold past a graph capture)
        out = src.new_empty((n, *src.shape))
        dist.all_gather_into_tensor(out, src, group=group)
        return torch.cat(out.unbind(0), dim=dim)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """This rank's chunk along `dim` of the sum of every rank's `t` (equal
    shapes, `dim` divisible by the group size), in group rank order: the
    piece that `all_gather_cat(piece, dim)` puts back together. The
    collective splits along its first dimension, so `dim` is moved there
    and back."""
    if not dist.is_initialized():
        return t
    n = group_size(group)
    src = t.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"dimension {dim} of size {src.shape[0]} does not "
                         f"divide over {n} ranks")
    shape = (src.shape[0] // n, *src.shape[1:])
    if _via_host(src, group):
        host = src.cpu()
        out = host.new_empty(shape)
        _reduce_scatter_tensor(out, host, group=group)
        out = out.to(t.device)
    else:
        out = src.new_empty(shape)
        _reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def send_recv(send: Sequence[torch.Tensor], dst: Optional[int],
              recv_like: Sequence[torch.Tensor], src: Optional[int],
              group=None) -> list:
    """Send the tensors `send` to group rank `dst` and receive tensors
    shaped like `recv_like` from group rank `src`, as one batch of
    point-to-point operations (dst or src None: that side is skipped).
    Returns the received tensors ([] when src is None)."""
    ops: List[dist.P2POp] = []
    probe = next(iter([*send, *recv_like]), None)
    staged = probe is not None and _via_host(probe, group)
    if dst is not None:
        peer = global_rank(group, dst)
        for t in send:
            buf = t.contiguous()
            ops.append(dist.P2POp(dist.isend, buf.cpu() if staged else buf,
                                  peer, group))
    out = []
    if src is not None:
        peer = global_rank(group, src)
        for like in recv_like:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device="cpu" if staged else like.device)
            out.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, peer, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if staged:
        out = [o.to(like.device) for o, like in zip(out, recv_like)]
    return out


def ppermute(xs: Sequence[torch.Tensor], perm: Sequence[tuple],
             group=None) -> list:
    """`lax.ppermute` of the tensors `xs` over `group`: group rank i sends
    them to j for each (i, j) in `perm`; a rank that receives nothing gets
    zeros."""
    me = group_rank(group)
    dst = next((j for i, j in perm if i == me), None)
    src = next((i for i, j in perm if j == me), None)
    if dst == me and src == me:
        return [x.clone() for x in xs]
    got = send_recv(xs, dst, xs, src, group)
    return got if src is not None else [torch.zeros_like(x) for x in xs]
