"""Seeded weights for the program and the reference alike.

A spec is {name: (shape, kind)} (the reference's, `reference/`). Every
value comes from one normal draw of a `torch.Generator` on the device,
in float32, the parameters' type in the program (it computes in bf16 from
float32 parameters):

- "fan_in": N(0, 1 / fan_in) for a convolution or linear weight (fan_in
  the product of all but the first axis), "fan_in_transposed" for a
  transposed convolution [C_in, C_out, k, k] (fan_in C_in k^2 / 4 at
  stride 2);
- "bias": N(0, 0.02^2); "gain": 1 + N(0, 0.1^2) (norm scales, LPIPS's
  channel weights); "embedding": N(0, 1); "codebook": N(0, (1/K)^2);
- "zeros", "ones": the BatchNorm running statistics' starting values.
"""

from __future__ import annotations

import math

import torch

__all__ = ["make_weights", "load_into"]


def _scale(shape, kind):
    if kind == "fan_in":
        return 1.0 / math.sqrt(math.prod(shape[1:]))
    if kind == "fan_in_transposed":
        return 1.0 / math.sqrt(shape[0] * math.prod(shape[2:]) / 4)
    if kind == "bias":
        return 0.02
    if kind == "gain":
        return 0.1
    if kind == "embedding":
        return 1.0
    if kind == "codebook":
        return 1.0 / shape[0]
    raise ValueError(f"unknown weight kind {kind!r}")


def make_weights(specs: dict, seed: int, device) -> dict:
    """{part: {name: tensor}} for {part: spec}: one draw of every random
    value, in the order of the parts and names given, from a generator on
    `device` seeded with `seed`."""
    entries = [(part, name, tuple(shape), kind)
               for part, spec in specs.items()
               for name, (shape, kind) in spec.items()]
    sizes = [math.prod(shape) if kind not in ("zeros", "ones") else 0
             for _, _, shape, kind in entries]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {part: {} for part in specs}
    offset = 0
    for (part, name, shape, kind), size in zip(entries, sizes):
        if kind == "zeros":
            out[part][name] = torch.zeros(shape, device=device)
            continue
        if kind == "ones":
            out[part][name] = torch.ones(shape, device=device)
            continue
        value = flat[offset:offset + size].view(shape) * _scale(shape, kind)
        out[part][name] = value + 1.0 if kind == "gain" else value
        offset += size
    return out


@torch.no_grad()
def load_into(module, weights: dict) -> None:
    """Copy `weights` into `module`'s parameters and buffers in place
    (the optimizers and captured graphs hold those tensors). Every entry
    of the module's state dict must be given, with its shape, and nothing
    else."""
    state = module.state_dict(keep_vars=True)
    missing = sorted(set(state) - set(weights))
    extra = sorted(set(weights) - set(state))
    if missing or extra:
        raise KeyError(f"{type(module).__name__}: the reference's weights "
                       f"lack {missing[:5]} and have no place for "
                       f"{extra[:5]}")
    for name, target in state.items():
        value = weights[name]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{name}: reference shape {tuple(value.shape)}"
                             f", program shape {tuple(target.shape)}")
        target.copy_(value)
