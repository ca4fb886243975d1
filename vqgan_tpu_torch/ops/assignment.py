"""Linear assignment on the device (a Bertsekas epsilon-auction) for
immiscible diffusion.

Counterpart of vqgan_tpu/ops/assignment.py, with the same bid order,
epsilon, iteration cap and greedy fix-up, so it returns the same
permutation as the JAX package for the same cost matrix. Unassigned person
i (the first one) bids for its best object j at price p_j + (best -
second best) + eps; the object changes owner and its price rises.
eps = range / (2b) bounds the total cost above the optimum by range / 2.

Each bid is a few small tensor operations on `dist`'s device, with no
host sync: the loop reads whether every person is assigned once per block
of b bids, and a bid made after that (there is none left to
make) changes nothing, by `torch.where` on an `active` flag. Without the
mask such a bid would bid for person 0, since argmax of all-False is 0.
On the card a block of bids is one captured CUDA graph (`graphs.ChainStep`)
replayed per block, with the one host read after it: the JAX package's
`while_loop` decides on the device, which a graph of this PyTorch cannot.
The graphs are kept across calls, by default in this module's
`ChainGraphs` (one graph per device, batch size and block length), so
only the first two calls of a shape run eagerly and capture.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..graphs import ChainGraphs, ChainStep, resolve_graph

__all__ = ["auction_assignment"]

# the blocks of bids' graphs of callers that keep none of their own
DEFAULT_GRAPHS = ChainGraphs()


def _bids(k: int):
    """The step body of a block of k bids over the carry (assign, owner,
    prices) and the consts (value, eps)."""
    def body(generators, carry, consts, row):
        assign, owner, prices = (carry["assign"], carry["owner"],
                                 carry["prices"])
        value, eps_ = consts["value"], consts["eps"]
        idx = torch.arange(value.shape[0], device=value.device)
        for _ in range(k):
            unassigned = assign < 0
            active = unassigned.any()
            # the first unassigned; gathers by 1-element index tensors
            i = unassigned.to(torch.uint8).argmax().reshape(1)
            net = value.index_select(0, i)[0] - prices
            j1 = net.argmax().reshape(1)
            is_j1 = idx == j1
            v2 = torch.where(is_j1, float("-inf"), net).max()
            # b == 1: v2 = -inf, the bid is eps alone
            incr = torch.where(torch.isfinite(v2), net.gather(0, j1)[0] - v2,
                               torch.zeros_like(v2)) + eps_
            prev = owner.gather(0, j1)
            new_assign = torch.where(idx == i, j1, assign)
            new_assign = torch.where((idx == prev) & (prev >= 0), -1,
                                     new_assign)  # evict the previous owner
            assign = torch.where(active, new_assign, assign)
            owner = torch.where(active & is_j1, i, owner)
            prices = torch.where(active & is_j1, prices + incr, prices)
        return {"assign": assign, "owner": owner, "prices": prices}

    return body


def auction_assignment(dist: torch.Tensor, eps: float | None = None,
                       max_iters: int | None = None, *,
                       graph: Optional[bool] = None,
                       graphs: Optional[ChainGraphs] = None) -> torch.Tensor:
    """cols[i] = object assigned to row i, minimising ~sum dist[i, cols[i]].

    dist: [b, b] cost matrix. Returns [b] int64 on dist's device, a
    permutation of 0..b-1. `graph` None replays a block of bids' captured
    graph on the card (False: the bids eagerly; True on the CPU raises),
    kept across calls in `graphs` (a `GaussianDiffusion` passes its own),
    by default in the module's."""
    b = dist.shape[0]
    if dist.shape != (b, b):
        raise ValueError(f"dist must be square, got {tuple(dist.shape)}")
    dev = dist.device
    value = -dist.detach().float()  # the auction maximises
    vrange = torch.clamp(value.max() - value.min(), min=1e-12)
    eps_ = vrange / (2.0 * b) if eps is None else torch.tensor(
        eps, dtype=torch.float32, device=dev)
    # an eps-auction ends within ~b * (range / eps + 1) bids
    cap = max_iters if max_iters is not None else 4 * b * (2 * b + 1)
    use_graph = resolve_graph(graph, dev)
    graphs = DEFAULT_GRAPHS if graphs is None else graphs
    neg_inf = torch.tensor(float("-inf"), device=dev)
    carry = {"assign": torch.full((b,), -1, dtype=torch.long, device=dev),
             "owner": torch.full((b,), -1, dtype=torch.long, device=dev),
             "prices": torch.zeros(b, dtype=torch.float32, device=dev)}
    consts = {"value": value, "eps": eps_}
    done, it = b == 0, 0
    while not done and it < cap:
        k = min(b, cap - it)
        carry = ChainStep(_bids(k), graphs=graphs, key=("auction", k, dev),
                          graph=use_graph, name=f"auction, {k} bids")(
                              carry, consts)
        it += k
        done = not bool((carry["assign"] < 0).any())  # one host read
    assign = carry["assign"]

    if not done:
        # the cap was hit: each person still unassigned, in order, takes
        # its best object still unowned (a valid permutation either way)
        owned = torch.zeros(b, dtype=torch.bool, device=dev)
        owned[assign[assign >= 0]] = True
        for i in range(b):
            need = assign[i] < 0
            j = torch.where(owned, neg_inf, value[i]).argmax()
            assign[i] = torch.where(need, j, assign[i])
            owned[j] = owned[j] | need
    return assign
