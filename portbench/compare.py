"""The numbers that decide `correct`: the program's readings against the
plain reference's.

Training (the first three steps that set-up drives through the window's
own call and feed):
- "loss": the largest relative gap of a step's loss, |program -
  reference| / |reference|, over the steps and the losses compared;
- "grad": the first step's gradient as the optimizer got it (clipped),
  worked out from its state after one step, by the worst leaf: the gap
  between the two norms of a leaf, |‖g_p‖ - ‖g_r‖|, over the larger of
  the reference's norm of that leaf and of the median leaf;
- "move": the parameters' change over the three steps, by the worst
  leaf, measured so; leaves whose reference gradient is under a
  thousandth of the median leaf's (a bias under softmax, weights that
  take no part) are left out, since Adam moves them by round-off alone;
- "grad_median": the first gradient's gap of the median leaf, measured as
  "grad" is: steady from seed to seed where the worst leaf (a small bias
  or norm gain) swings;
- "loss1": the first step's loss gap alone;
- "codes" (a quantizer's choices, which the reference follows): the
  largest shift of the reference's z, as a share of |z|, that makes one
  of the program's codes as near as the nearest one; infinite where the
  program gave no code (`reference/vqgan.py`'s `quantize`).

Generation (requests of the window, a sample drawn from the seed):
- "latent": the largest relative RMS gap of a request's latents,
  ‖program - reference‖ / ‖reference‖;
- "chain": a request's "latent" over the gap of the reference's chain
  with bf16 operands, the largest: the chain's own amplification of
  rounding, which differs from request to request, divided out;
- "image": the relative RMS gap of the decoded images.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Tuple

import torch

__all__ = ["loss_gap", "leaf_gap", "leaf_gaps", "rel_rms_gap",
           "quiet_leaves"]

QUIET = 1e-3


def loss_gap(program: Iterable[float], reference: Iterable[float]) -> float:
    gaps = [abs(p - r) / max(abs(r), 1e-12)
            for p, r in zip(program, reference)]
    return max(gaps) if gaps else float("nan")


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def quiet_leaves(ref_grads: Dict[str, torch.Tensor]) -> set:
    """Leaves whose reference gradient's norm is under `QUIET` times the
    median leaf's."""
    norms = _norms(ref_grads)
    median = statistics.median(norms.values())
    return {k for k, n in norms.items() if n < QUIET * median}


def leaf_gaps(program: Dict[str, torch.Tensor],
              reference: Dict[str, torch.Tensor],
              leave_out: Optional[set] = None) -> Dict[str, float]:
    """{leaf: |‖p‖ - ‖r‖| / max(‖r‖, median ‖r‖)} over the reference's
    leaves less `leave_out`. A leaf the program lacks is a fault: it reads
    as infinite."""
    keys = [k for k in reference if k not in (leave_out or set())]
    ref = _norms({k: reference[k] for k in keys})
    median = statistics.median(ref.values())
    gaps = {}
    for k in keys:
        if k not in program:
            gaps[k] = float("inf")
            continue
        p = float(program[k].detach().double().norm())
        gaps[k] = abs(p - ref[k]) / max(ref[k], median, 1e-30)
    return gaps


def leaf_gap(program: Dict[str, torch.Tensor],
             reference: Dict[str, torch.Tensor],
             leave_out: Optional[set] = None) -> Tuple[float, str]:
    """(the worst leaf's gap of `leaf_gaps`, its name); NaN is worst."""
    worst, name = 0.0, ""
    for k, gap in leaf_gaps(program, reference, leave_out).items():
        if gap > worst or not gap == gap:
            worst, name = gap, k
    return worst, name


def rel_rms_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    p, r = program.double(), reference.double()
    return float((p - r).norm() / r.norm().clamp(min=1e-30))
