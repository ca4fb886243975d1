"""Plain building blocks of the reference: functional float32 PyTorch over
a dict of named weights, no kernel and no module of the program.

Every matrix product and convolution takes its two operands through a
`Precision`: float32 leaves them as they are (TF32 is switched off while
the reference runs, `float32_math`); "float8" rounds each operand to
float8 e4m3 with a per-tensor scale (amax / 448) and computes the product
in float32 from the rounded values, with the gradient passed straight
through. These lower precisions are the controls the comparison must
fail: float8 below bf16, and TF32 (`tf32_math`: the card's TF32 products)
below float32 with TF32 off.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

__all__ = ["Precision", "float32_math", "tf32_math", "conv2d",
           "conv_transpose2d",
           "linear", "matmul", "group_norm", "rms_norm", "batch_norm",
           "single_head_attention", "adam_update", "global_norm"]


class Precision:
    """How the operands of a product are rounded: "float32" (not at all),
    "bfloat16" (to bf16, the rounding a sound bf16 program makes at
    least), or "float8" (e4m3, per-tensor scale)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "bfloat16", "float8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x
        held = x.detach()
        if self.name == "bfloat16":
            return x + (held.to(torch.bfloat16).to(x.dtype) - held)
        scale = held.abs().amax().clamp(min=1e-30) / 448.0
        rounded = (held / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        return x + (rounded - held)


@contextlib.contextmanager
def _tf32(allowed: bool):
    cuda = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allowed
    torch.backends.cudnn.allow_tf32 = allowed
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def float32_math():
    """Full float32 products on the card (TF32 off) inside the block."""
    return _tf32(False)


def tf32_math():
    """The card's TF32 products for float32 inside the block."""
    return _tf32(True)


def conv2d(x, w, b, pr: Precision, stride: int = 1, padding: int = 0):
    return F.conv2d(pr(x), pr(w), b, stride=stride, padding=padding)


def conv_transpose2d(x, w, b, pr: Precision, stride: int = 2,
                     padding: int = 1):
    return F.conv_transpose2d(pr(x), pr(w), b, stride=stride,
                              padding=padding)


def linear(x, w, b, pr: Precision):
    return F.linear(pr(x), pr(w), b)


def matmul(a, b, pr: Precision):
    return torch.matmul(pr(a), pr(b))


def _groups(channels: int, groups: int = 32) -> int:
    groups = min(groups, channels)
    while channels % groups:
        groups -= 1
    return groups


def group_norm(x, w, b, eps: float = 1e-6):
    """GroupNorm with 32 groups (fewer where they do not divide)."""
    return F.group_norm(x, _groups(x.shape[1]), w, b, eps)


def rms_norm(x, g):
    """x / |x| over channels, times g and sqrt(C); 1e-12 inside the root."""
    return (x * torch.rsqrt((x * x).sum(dim=1, keepdim=True) + 1e-12) * g
            * math.sqrt(x.shape[1]))


def batch_norm(x, w, b, running_mean, running_var, train: bool,
               momentum: float = 0.1, eps: float = 1e-5):
    """BatchNorm over NCHW channels. Train mode normalises by the batch's
    biased variance and moves the running statistics (in place) towards
    the batch's mean and biased variance; eval mode uses them."""
    if not train:
        mean, var = running_mean, running_var
    else:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            running_mean.mul_(1.0 - momentum).add_(momentum * mean)
            running_var.mul_(1.0 - momentum).add_(momentum * var)
    inv = torch.rsqrt(var + eps)
    return ((x - mean[None, :, None, None]) * (inv * w)[None, :, None, None]
            + b[None, :, None, None])


def single_head_attention(q, k, v, pr: Precision, heads: int = 1):
    """softmax(q k^T / sqrt(d)) v over [B, S, heads * d] rows."""
    bsz, s, c = q.shape
    d = c // heads

    def split(t):
        return t.reshape(bsz, t.shape[1], heads, d).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    logits = matmul(qh, kh.transpose(-1, -2), pr) / math.sqrt(d)
    out = matmul(torch.softmax(logits, dim=-1), vh, pr)
    return out.transpose(1, 2).reshape(bsz, s, c)


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum((t.double() ** 2).sum() for t in tensors)).float()


def adam_update(params, grads, state: dict, *, lr: float, betas, eps: float,
                weight_decay: float, max_norm: float):
    """One clipped Adam(W) update in place, as optax chains
    clip_by_global_norm and adam(w): g * max / |g| where |g| > max; AdamW's
    decay p *= 1 - lr wd before the Adam step. Returns the clipped
    gradients (what the moments were fed)."""
    norm = global_norm(grads)
    factor = 1.0 if float(norm) < max_norm else max_norm / float(norm)
    clipped = [g * factor for g in grads]
    b1, b2 = betas
    n = state["count"] = state.get("count", 0) + 1
    if "m" not in state:
        state["m"] = [torch.zeros_like(p) for p in params]
        state["v"] = [torch.zeros_like(p) for p in params]
    with torch.no_grad():
        for p, g, m, v in zip(params, clipped, state["m"], state["v"]):
            m.mul_(b1).add_((1.0 - b1) * g)
            v.mul_(b2).add_((1.0 - b2) * g * g)
            if weight_decay:
                p.mul_(1.0 - lr * weight_decay)
            denom = v.sqrt() / math.sqrt(1.0 - b2 ** n) + eps
            p.sub_(lr / (1.0 - b1 ** n) * m / denom)
    return clipped
