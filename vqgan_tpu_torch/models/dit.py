"""DiT: the class-conditional diffusion transformer denoiser (adaLN-zero).

Counterpart of `DiT` and `DiTBlock` in vqgan_tpu/models/dit.py, with the
call contract of `CFGUnet`: forward(x [B,C,H,W], time [B], classes [B], *,
cond_drop_mask / cond_drop_prob / generator, return_features) ->
[B, out_ch, H, W] fp32. Parameters are fp32; the blocks compute in `dtype`
and the final projection in fp32.

Parity points with the JAX package (flax defaults):
- the token stream is fp32 between the blocks: the bf16 patch embedding
  meets the fp32 position embedding, and each gated branch is added back to
  it, so the residual sums promote to fp32 as in JAX;
- LayerNorm has eps 1e-6, no scale or bias, statistics in fp32 with the
  variance as E[x^2] - E[x]^2 (clipped at 0), output in `dtype`;
- GELU is the tanh approximation;
- `ada_mod` splits into (shift, scale, gate) for attention, then for the MLP;
- the feature tap is the token mean after block depth // 2 - 1;
- unpatchify takes [B, g, g, p, p, C] to [B, g*p, g*p, C] by swapping the
  second and third axes, here written for NCHW.
Attention runs through the port's `sdpa` (the flash kernels on CUDA) on
[B, N, heads, dim_head] views of the qkv projection.

`stacked_block_params` and `dit_pipeline_forward` run the block stack as
a GPipe pipeline over a mesh's "stage" axis (parallel/pp.py); each stage
runs `DiTBlock`s, so the flax defaults above hold there too.

Parameter names (the JAX package has no PyTorch reader for a DiT, so
`checkpoint/from_jax.py:dit_state_from_jax` defines the mapping):
`patch_embed`, `pos_emb` [1, N, dim], `time_mlp_in`, `time_mlp_out`,
`classes_emb`, `null_classes_emb`, `blocks.{i}.{ada_mod,to_qkv,to_out,
mlp_in,mlp_out}`, `final_mod`, `final_proj`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from .layers import Conv2d, Linear, lecun_normal_init_
from .unet_cfg import SinusoidalPosEmb, draw_cond_drop_mask

__all__ = ["DiT", "DiTBlock", "dit_pipeline_forward", "layer_norm",
           "stacked_block_params"]


def layer_norm(x, dtype, eps: float = 1e-6):
    """flax's LayerNorm without scale or bias: fp32 statistics, the
    variance as max(E[x^2] - E[x]^2, 0), the result in `dtype`."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return ((x - mean) * torch.rsqrt(var + eps)).to(dtype)


def _modulate(h, shift, scale):
    return h * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _zero_(*layers):
    for layer in layers:
        nn.init.zeros_(layer.weight)
        if layer.bias is not None:
            nn.init.zeros_(layer.bias)


class DiTBlock(nn.Module):
    """One adaLN-zero transformer block, the identity at initialisation:
    forward(x [B, N, dim], c [B, dim]) -> [B, N, dim]."""

    def __init__(self, dim: int, heads: int = 6, dim_head: int = 64,
                 mlp_mult: int = 4, dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        hidden = heads * dim_head
        self.ada_mod = Linear(dim, 6 * dim, dtype=dtype)
        self.to_qkv = Linear(dim, 3 * hidden, bias=False, dtype=dtype)
        self.to_out = Linear(hidden, dim, bias=False, dtype=dtype)
        self.mlp_in = Linear(dim, dim * mlp_mult, dtype=dtype)
        self.mlp_out = Linear(dim * mlp_mult, dim, dtype=dtype)

    def forward(self, x, c):
        (shift_a, scale_a, gate_a,
         shift_m, scale_m, gate_m) = self.ada_mod(F.silu(c)).chunk(6, dim=-1)

        b, n, _ = x.shape
        h = _modulate(layer_norm(x, self.dtype), shift_a, scale_a)
        shape = (b, n, self.heads, self.dim_head)
        q, k, v = (t.reshape(shape) for t in self.to_qkv(h).chunk(3, dim=-1))
        out = self.to_out(sdpa(q, k, v).reshape(b, n, -1))
        x = x + gate_a[:, None, :] * out

        h = _modulate(layer_norm(x, self.dtype), shift_m, scale_m)
        h = self.mlp_out(F.gelu(self.mlp_in(h), approximate="tanh"))
        return x + gate_m[:, None, :] * h


class DiT(nn.Module):
    """The DiT denoiser: patch embedding, `depth` DiTBlocks conditioned on
    time + class, the final adaLN and a zero-initialised fp32 projection,
    unpatchified to the input's grid."""

    def __init__(self, dim: int = 384, depth: int = 8, heads: int = 6,
                 dim_head: int = 64, patch_size: int = 2,
                 image_size: int = 32, channels: int = 4,
                 num_classes: int = 31, cond_drop_prob: float = 0.1,
                 mlp_mult: int = 4, learned_variance: bool = False,
                 dtype=torch.float32):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image_size {image_size} is not a multiple of "
                             f"patch_size {patch_size}")
        self.dim, self.depth, self.patch_size = dim, depth, patch_size
        self.grid = image_size // patch_size
        self.cond_drop_prob = cond_drop_prob
        self.dtype = dtype
        self.out_ch = channels * (2 if learned_variance else 1)

        self.patch_embed = Conv2d(channels, dim, patch_size,
                                  stride=patch_size, dtype=dtype)
        self.pos_emb = nn.Parameter(
            0.02 * torch.randn(1, self.grid * self.grid, dim))
        self.sinu_pos_emb = SinusoidalPosEmb(dim)
        self.time_mlp_in = Linear(dim, dim * 4, dtype=dtype)
        self.time_mlp_out = Linear(dim * 4, dim, dtype=dtype)
        self.classes_emb = nn.Embedding(num_classes, dim)
        self.null_classes_emb = nn.Parameter(torch.randn(dim))
        self.blocks = nn.ModuleList(
            DiTBlock(dim, heads, dim_head, mlp_mult, dtype=dtype)
            for _ in range(depth))
        self.final_mod = Linear(dim, 2 * dim, dtype=dtype)
        self.final_proj = Linear(dim, patch_size * patch_size * self.out_ch)

        # flax's initialisers: lecun_normal kernels and zero biases, the
        # adaLN-zero projections all zero
        lecun_normal_init_(self)
        _zero_(self.final_mod, self.final_proj,
               *(blk.ada_mod for blk in self.blocks))

    def embed(self, x, time, classes, cond_drop_mask=None,
              cond_drop_prob=None, generator=None):
        """-> (tokens [B, N, dim] fp32, conditioning c [B, dim] fp32)."""
        b = x.shape[0]
        tokens = self.patch_embed(x.to(self.dtype)).flatten(2).transpose(1, 2)
        tokens = tokens + self.pos_emb

        cls = self.classes_emb(classes)
        if cond_drop_mask is None:
            p = self.cond_drop_prob if cond_drop_prob is None else cond_drop_prob
            cond_drop_mask = draw_cond_drop_mask(b, p, generator, x.device)
        if cond_drop_mask is not None:
            cls = torch.where(cond_drop_mask[:, None],
                              self.null_classes_emb[None, :], cls)
        temb = self.time_mlp_out(F.gelu(
            self.time_mlp_in(self.sinu_pos_emb(time)), approximate="tanh"))
        return tokens, temb + cls

    def head(self, tokens, c):
        """Final adaLN, the fp32 projection, unpatchify -> [B, out_ch, H, W]."""
        shift, scale = self.final_mod(F.silu(c)).chunk(2, dim=-1)
        out = self.final_proj(_modulate(layer_norm(tokens, self.dtype),
                                        shift, scale))
        b, p, g = out.shape[0], self.patch_size, self.grid
        # [b, (gh gw), (ph pw c)] -> [b, c, gh ph, gw pw]
        out = out.reshape(b, g, g, p, p, self.out_ch)
        return out.permute(0, 5, 1, 3, 2, 4).reshape(b, self.out_ch, g * p,
                                                     g * p)

    def forward(self, x, time, classes, *,
                cond_drop_mask: Optional[torch.Tensor] = None,
                cond_drop_prob: Optional[float] = None,
                generator: Optional[torch.Generator] = None,
                return_features: bool = False):
        """cond_drop_mask (bool [B], True selects the learned null class
        embedding) is what the CFG sampler passes. Without it, classes are
        dropped at random with `cond_drop_prob` (default: the model's) drawn
        from `generator`."""
        tokens, c = self.embed(x, time, classes, cond_drop_mask,
                               cond_drop_prob, generator)
        features = None
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens, c)
            if return_features and i == self.depth // 2 - 1:
                features = tokens.float().mean(dim=1)
        out = self.head(tokens, c)
        if return_features:
            return out, features
        return out


def stacked_block_params(model: DiT) -> dict:
    """The blocks' parameters stacked into one name -> [depth, ...] dict
    (the parallel/pp.py contract); differentiable back to the blocks."""
    from ..parallel.pp import stack_params

    return stack_params([dict(blk.named_parameters())
                         for blk in model.blocks])


def dit_pipeline_forward(model: DiT, x, time, classes, mesh, *,
                         num_microbatches: int, cond_drop_mask=None,
                         stacked=None):
    """The DiT forward with its block stack pipelined over the mesh's
    "stage" axis; the embedding and the head run on every stage (a small
    share of the work). Equals `model(x, time, classes,
    cond_drop_mask=...)` (same math, same order). `x`, `time`, `classes`
    and the mask are this rank's rows. No class is dropped at random
    (CFG dropout belongs to training callers, who pass the mask).

    `stacked`: this stage's blocks from `shard_stacked_params`, to place
    them once for many calls; by default they come from `model`."""
    from torch.func import functional_call

    from ..parallel.pp import pipeline_apply, shard_stacked_params

    tokens, c = model.embed(x, time, classes, cond_drop_mask, 0.0)
    template = model.blocks[0]

    def block_fn(p, carry):
        t_, c_ = carry
        return functional_call(template, p, (t_, c_)), c_

    if stacked is None:
        stacked = shard_stacked_params(stacked_block_params(model), mesh)
    tokens, c = pipeline_apply(block_fn, stacked, (tokens, c), mesh,
                               num_microbatches=num_microbatches)
    return model.head(tokens, c)
