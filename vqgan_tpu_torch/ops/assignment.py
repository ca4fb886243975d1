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
"""

from __future__ import annotations

import torch

__all__ = ["auction_assignment"]


def auction_assignment(dist: torch.Tensor, eps: float | None = None,
                       max_iters: int | None = None) -> torch.Tensor:
    """cols[i] = object assigned to row i, minimising ~sum dist[i, cols[i]].

    dist: [b, b] cost matrix. Returns [b] int64 on dist's device, a
    permutation of 0..b-1."""
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
    idx = torch.arange(b, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)

    assign = torch.full((b,), -1, dtype=torch.long, device=dev)
    owner = torch.full((b,), -1, dtype=torch.long, device=dev)
    prices = torch.zeros(b, dtype=torch.float32, device=dev)
    done, it = b == 0, 0
    while not done and it < cap:
        for _ in range(min(b, cap - it)):
            unassigned = assign < 0
            active = unassigned.any()
            i = unassigned.to(torch.uint8).argmax()  # first unassigned
            net = value[i] - prices
            j1 = net.argmax()
            is_j1 = idx == j1
            v2 = torch.where(is_j1, neg_inf, net).max()
            # b == 1: v2 = -inf, the bid is eps alone
            incr = torch.where(torch.isfinite(v2), net[j1] - v2,
                               torch.zeros_like(v2)) + eps_
            prev = owner[j1]
            new_assign = torch.where(idx == i, j1, assign)
            new_assign = torch.where((idx == prev) & (prev >= 0), -1,
                                     new_assign)  # evict the previous owner
            assign = torch.where(active, new_assign, assign)
            owner = torch.where(active & is_j1, i, owner)
            prices = torch.where(active & is_j1, prices + incr, prices)
        it += min(b, cap - it)
        done = not bool((assign < 0).any())  # one host read per block

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
