"""The convolutional encoder and decoder of the stage-1 autoencoders (the
VQ-VAE's and the KL-VAE's), in plain float32 over named weights.

The layout is the taming-transformers / Stable Diffusion trunk that the
reference repository's models use: per level `num_res_blocks` ResNet
blocks (GroupNorm 32, eps 1e-6, SiLU, 3x3 convolutions, a 1x1 shortcut
where the width changes), single-head self-attention blocks where the
level's resolution is in `attn_resolutions`, a stride-2 3x3 convolution
down (padding 1) and a stride-2 4x4 transposed convolution up (padding
1); a middle of block, attention, block. The decoder has one block more
per level. Weight names are those of the reference PyTorch models, so
the same seeded weights load into the program's modules by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import (
    Precision,
    conv2d,
    conv_transpose2d,
    group_norm,
    single_head_attention,
)

__all__ = ["trunk_spec", "encode", "decode"]


def _conv(spec, name, c_in, c_out, k, bias=True):
    spec[f"{name}.weight"] = ((c_out, c_in, k, k), "fan_in")
    if bias:
        spec[f"{name}.bias"] = ((c_out,), "bias")


def _norm(spec, name, c):
    spec[f"{name}.weight"] = ((c,), "gain")
    spec[f"{name}.bias"] = ((c,), "bias")


def _resnet(spec, name, c_in, c_out):
    _norm(spec, f"{name}.norm1", c_in)
    _conv(spec, f"{name}.conv1", c_in, c_out, 3)
    _norm(spec, f"{name}.norm2", c_out)
    _conv(spec, f"{name}.conv2", c_out, c_out, 3)
    if c_in != c_out:
        _conv(spec, f"{name}.nin_shortcut", c_in, c_out, 1)


def _attn(spec, name, c):
    _norm(spec, f"{name}.norm", c)
    for part in ("q", "k", "v", "proj_out"):
        _conv(spec, f"{name}.{part}", c, c, 1)


def _mid(spec, name, c):
    _resnet(spec, f"{name}.block_1", c, c)
    _attn(spec, f"{name}.attn_1", c)
    _resnet(spec, f"{name}.block_2", c, c)


def trunk_spec(cfg: dict, prefix: str = "", encoder: bool = True,
               decoder: bool = True, double_z: bool = False) -> dict:
    """{name: (shape, kind)} of the encoder and/or decoder. `cfg` holds
    ch, ch_mult, num_res_blocks, attn_resolutions, resolution,
    z_channels, in_channels, out_channels."""
    spec = {}
    ch, mults = cfg["ch"], list(cfg["ch_mult"])
    nrb, attn_res = cfg["num_res_blocks"], list(cfg["attn_resolutions"])
    z = cfg["z_channels"]
    if encoder:
        e = f"{prefix}encoder"
        _conv(spec, f"{e}.conv_in", cfg["in_channels"], ch, 3)
        res, c_in = cfg["resolution"], ch
        for i, m in enumerate(mults):
            c_out = ch * m
            for j in range(nrb):
                _resnet(spec, f"{e}.down.{i}.block.{j}", c_in, c_out)
                c_in = c_out
                if res in attn_res:
                    _attn(spec, f"{e}.down.{i}.attn.{j}", c_in)
            if i != len(mults) - 1:
                _conv(spec, f"{e}.down.{i}.downsample", c_in, c_in, 3)
                res //= 2
        _mid(spec, f"{e}.mid", c_in)
        _norm(spec, f"{e}.norm_out", c_in)
        _conv(spec, f"{e}.conv_out", c_in, 2 * z if double_z else z, 3)
    if decoder:
        d = f"{prefix}decoder"
        c_in = ch * mults[-1]
        res = cfg["resolution"] // 2 ** (len(mults) - 1)
        _conv(spec, f"{d}.conv_in", z, c_in, 3)
        _mid(spec, f"{d}.mid", c_in)
        for i in reversed(range(len(mults))):
            c_out = ch * mults[i]
            for j in range(nrb + 1):
                _resnet(spec, f"{d}.up.{i}.block.{j}", c_in, c_out)
                c_in = c_out
                if res in attn_res:
                    _attn(spec, f"{d}.up.{i}.attn.{j}", c_in)
            if i != 0:
                spec[f"{d}.up.{i}.upsample.weight"] = ((c_in, c_in, 4, 4),
                                                      "fan_in_transposed")
                spec[f"{d}.up.{i}.upsample.bias"] = ((c_in,), "bias")
                res *= 2
        _norm(spec, f"{d}.norm_out", c_in)
        _conv(spec, f"{d}.conv_out", c_in, cfg["out_channels"], 3)
    return spec


def _c(W, name, x, pr, stride=1, padding=0):
    return conv2d(x, W[f"{name}.weight"], W.get(f"{name}.bias"), pr,
                  stride=stride, padding=padding)


def _gn(W, name, x):
    return group_norm(x, W[f"{name}.weight"], W[f"{name}.bias"])


def resnet_block(W, name, x, pr):
    h = _c(W, f"{name}.conv1", F.silu(_gn(W, f"{name}.norm1", x)), pr,
           padding=1)
    h = _c(W, f"{name}.conv2", F.silu(_gn(W, f"{name}.norm2", h)), pr,
           padding=1)
    if f"{name}.nin_shortcut.weight" in W:
        x = _c(W, f"{name}.nin_shortcut", x, pr)
    return x + h


def attn_block(W, name, x, pr):
    b, c, h, w = x.shape
    hn = _gn(W, f"{name}.norm", x)

    def rows(part):
        return _c(W, f"{name}.{part}", hn, pr).reshape(b, c, h * w
                                                       ).transpose(1, 2)

    out = single_head_attention(rows("q"), rows("k"), rows("v"), pr)
    out = out.transpose(1, 2).reshape(b, c, h, w)
    return x + _c(W, f"{name}.proj_out", out, pr)


def _mid_forward(W, name, x, pr):
    x = resnet_block(W, f"{name}.block_1", x, pr)
    x = attn_block(W, f"{name}.attn_1", x, pr)
    return resnet_block(W, f"{name}.block_2", x, pr)


def encode(W, cfg: dict, x, pr: Precision, prefix: str = ""):
    """NCHW images -> the encoder's NCHW output (before any quantizer)."""
    e = f"{prefix}encoder"
    mults, nrb = list(cfg["ch_mult"]), cfg["num_res_blocks"]
    h = _c(W, f"{e}.conv_in", x, pr, padding=1)
    for i in range(len(mults)):
        for j in range(nrb):
            h = resnet_block(W, f"{e}.down.{i}.block.{j}", h, pr)
            if f"{e}.down.{i}.attn.{j}.q.weight" in W:
                h = attn_block(W, f"{e}.down.{i}.attn.{j}", h, pr)
        if i != len(mults) - 1:
            h = _c(W, f"{e}.down.{i}.downsample", h, pr, stride=2, padding=1)
    h = _mid_forward(W, f"{e}.mid", h, pr)
    return _c(W, f"{e}.conv_out", F.silu(_gn(W, f"{e}.norm_out", h)), pr,
              padding=1)


def decode(W, cfg: dict, z, pr: Precision, prefix: str = ""):
    """NCHW latents -> the decoder's NCHW output (no final activation)."""
    d = f"{prefix}decoder"
    mults, nrb = list(cfg["ch_mult"]), cfg["num_res_blocks"]
    h = _mid_forward(W, f"{d}.mid", _c(W, f"{d}.conv_in", z, pr, padding=1),
                     pr)
    for i in reversed(range(len(mults))):
        for j in range(nrb + 1):
            h = resnet_block(W, f"{d}.up.{i}.block.{j}", h, pr)
            if f"{d}.up.{i}.attn.{j}.q.weight" in W:
                h = attn_block(W, f"{d}.up.{i}.attn.{j}", h, pr)
        if i != 0:
            h = conv_transpose2d(h, W[f"{d}.up.{i}.upsample.weight"],
                                 W[f"{d}.up.{i}.upsample.bias"], pr)
    return _c(W, f"{d}.conv_out", F.silu(_gn(W, f"{d}.norm_out", h)), pr,
              padding=1)


def zeros_like_spec(spec: dict, device) -> dict:
    """Zero tensors of the spec's shapes (for shape-only FLOP counts)."""
    return {k: torch.zeros(shape, device=device)
            for k, (shape, _) in spec.items()}
