"""The JAX package's parameter trees as the port's state dicts.

`klvae_state_from_jax`, `cfg_unet_state_from_jax`, `dit_state_from_jax`,
`ddpm_unet_state_from_jax`, `karras_unet_state_from_jax`,
`uvit_state_from_jax`, `unet1d_state_from_jax`,
`karras_unet_nd_state_from_jax`, `learned_log_snr_state_from_jax`,
`vqvae_state_from_jax`, `patchgan_state_from_jax`, `lpips_state_from_jax`,
`resnet_state_from_jax` and `inception_state_from_jax` take the variables
of vqgan_tpu's KLVAE / CFGUnet / DiT / Unet / KarrasUnet / UViT / Unet1D
/ KarrasUnet1D and 3D / LearnedLogSNR / VQVAE /
PatchGANDiscriminator / LPIPS / ResNet / InceptionV3Features as nested dicts of numpy arrays (`{"params": ...}` or
the inner dict; the discriminator's, the ResNet's and Inception's with
their `batch_stats`) and return a `state_dict` for the port's module. The port's names and shapes are the
reference PyTorch models', so this is the inverse of the JAX package's
checkpoint/torch_import.py (`load_torch_klvae`, `load_torch_cfg_unet`,
`load_torch_vqvae`, `load_torch_patchgan`, and the LPIPS module's
`load_torch_lpips_weights`):
- flax conv HWIO -> OIHW;
- flax ConvTranspose HWIO -> torch [in, out, kh, kw] with the taps flipped;
- flax Dense [in, out] -> Linear [out, in];
- GroupNorm scale/bias -> weight/bias; RMSNorm g [C] -> [1, C, 1, 1].
- BatchNorm scale/bias -> weight/bias, batch_stats mean/var ->
  running_mean/running_var.
The JAX tree's autonames (LinearAttention_{i}, CrossAttentionCond_{i},
Attention_0, Dense_0..3) are mapped as torch_import maps them. The JAX
package has no PyTorch reader for the DiT, the DDPM `Unet`, the Karras
U-Nets, the UViT, the `Unet1D` or the learned log-SNR schedule, so their
converters define the names (models/dit.py, models/unet.py,
models/karras_unet.py, models/karras_unet_nd.py, models/uvit.py,
models/unet1d.py, diffusion/continuous_time.py); every tensor is copied,
never shared. Convolutions of any rank go from flax's [*k, in, out] to
[out, in, *k].
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["klvae_state_from_jax", "cfg_unet_state_from_jax",
           "dit_state_from_jax", "ddpm_unet_state_from_jax",
           "karras_unet_state_from_jax", "uvit_state_from_jax",
           "unet1d_state_from_jax", "karras_unet_nd_state_from_jax",
           "learned_log_snr_state_from_jax", "vqvae_state_from_jax",
           "patchgan_state_from_jax", "lpips_state_from_jax", "resnet_state_from_jax",
           "inception_state_from_jax"]


def _t(a) -> torch.Tensor:
    # copy: the caller's arrays may be read-only or shared
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _params(tree) -> dict:
    return tree["params"] if "params" in tree else tree


def _kernel(a) -> torch.Tensor:
    """A flax conv kernel [*k, in, out] as torch's [out, in, *k]."""
    a = np.asarray(a)
    return _t(np.transpose(a, (a.ndim - 1, a.ndim - 2, *range(a.ndim - 2))))


def _conv(out, key, p):
    out[f"{key}.weight"] = _kernel(p["kernel"])
    if "bias" in p:
        out[f"{key}.bias"] = _t(p["bias"])


def _conv_transpose(out, key, p):
    w = np.transpose(p["kernel"], (2, 3, 0, 1))[:, :, ::-1, ::-1]
    out[f"{key}.weight"] = _t(w)
    out[f"{key}.bias"] = _t(p["bias"])


def _dense(out, key, p):
    out[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{key}.bias"] = _t(p["bias"])


def _groupnorm(out, key, p):
    out[f"{key}.weight"] = _t(p["GroupNorm_0"]["scale"])
    out[f"{key}.bias"] = _t(p["GroupNorm_0"]["bias"])


def _rms(out, key, p, spatial_dims: int = 2):
    out[key] = _t(np.asarray(p["g"]).reshape(1, -1, *((1,) * spatial_dims)))


# --- KL-VAE ---------------------------------------------------------------


def _resblock(out, prefix, p):
    _groupnorm(out, f"{prefix}.norm1", p["GroupNorm_0"])
    _conv(out, f"{prefix}.conv1", p["conv1"])
    _groupnorm(out, f"{prefix}.norm2", p["GroupNorm_1"])
    _conv(out, f"{prefix}.conv2", p["conv2"])
    if "nin_shortcut" in p:
        _conv(out, f"{prefix}.nin_shortcut", p["nin_shortcut"])


def _attnblock(out, prefix, p):
    _groupnorm(out, f"{prefix}.norm", p["GroupNorm_0"])
    for name in ("q", "k", "v", "proj_out"):
        _conv(out, f"{prefix}.{name}", p[name])


def _mid(out, prefix, p):
    _resblock(out, f"{prefix}.mid.block_1", p["mid_block_1"])
    _attnblock(out, f"{prefix}.mid.attn_1", p["mid_attn_1"])
    _resblock(out, f"{prefix}.mid.block_2", p["mid_block_2"])


def _levels(p, kind):
    """Per-level (blocks, attns) keys of an encoder ('down') or decoder
    ('up') tree: {level: ([block keys], [attn keys])}."""
    levels: Dict[int, tuple] = {}
    for key in p:
        parts = key.split("_")
        if parts[0] == kind and parts[2] in ("block", "attn"):
            blocks, attns = levels.setdefault(int(parts[1]), ([], []))
            (blocks if parts[2] == "block" else attns).append(int(parts[3]))
    return levels


def _encoder(out, p):
    _conv(out, "encoder.conv_in", p["conv_in"])
    for i, (blocks, attns) in sorted(_levels(p, "down").items()):
        for j in sorted(blocks):
            _resblock(out, f"encoder.down.{i}.block.{j}", p[f"down_{i}_block_{j}"])
        for j in sorted(attns):
            _attnblock(out, f"encoder.down.{i}.attn.{j}", p[f"down_{i}_attn_{j}"])
        if f"down_{i}_downsample" in p:
            _conv(out, f"encoder.down.{i}.downsample",
                  p[f"down_{i}_downsample"]["Conv_0"])
    _mid(out, "encoder", p)
    _groupnorm(out, "encoder.norm_out", p["norm_out"])
    _conv(out, "encoder.conv_out", p["conv_out"])


def _decoder(out, p):
    _conv(out, "decoder.conv_in", p["conv_in"])
    _mid(out, "decoder", p)
    for i, (blocks, attns) in sorted(_levels(p, "up").items()):
        for j in sorted(blocks):
            _resblock(out, f"decoder.up.{i}.block.{j}", p[f"up_{i}_block_{j}"])
        for j in sorted(attns):
            _attnblock(out, f"decoder.up.{i}.attn.{j}", p[f"up_{i}_attn_{j}"])
        if f"up_{i}_upsample" in p:
            _conv_transpose(out, f"decoder.up.{i}.upsample",
                            p[f"up_{i}_upsample"]["ConvTranspose_0"])
    _groupnorm(out, "decoder.norm_out", p["norm_out"])
    _conv(out, "decoder.conv_out", p["conv_out"])


def klvae_state_from_jax(tree) -> Dict[str, torch.Tensor]:
    """vqgan_tpu KLVAE params -> state dict of the port's KLVAE."""
    p = _params(tree)
    out: Dict[str, torch.Tensor] = {}
    _encoder(out, p["encoder"])
    _decoder(out, p["decoder"])
    _conv(out, "quant_conv", p["quant_conv"])
    _conv(out, "post_quant_conv", p["post_quant_conv"])
    return out


# --- CFG U-Net ------------------------------------------------------------


def _film_resblock(out, prefix, p):
    _dense(out, f"{prefix}.mlp.1", p["mlp"])
    for block in ("block1", "block2"):
        _conv(out, f"{prefix}.{block}.proj", p[block]["proj"])
        _rms(out, f"{prefix}.{block}.norm.g", p[block]["RMSNorm_0"])
    if "res_conv" in p:
        _conv(out, f"{prefix}.res_conv", p["res_conv"])


def _linear_attention(out, prefix, prenorm, inner):
    _rms(out, f"{prefix}.fn.norm.g", prenorm["norm"])
    _conv(out, f"{prefix}.fn.fn.to_qkv", inner["to_qkv"])
    _conv(out, f"{prefix}.fn.fn.to_out.0", inner["to_out"])
    _rms(out, f"{prefix}.fn.fn.to_out.1.g", inner["out_norm"])


def _full_attention(out, prefix, prenorm, inner):
    _rms(out, f"{prefix}.fn.norm.g", prenorm["norm"])
    _conv(out, f"{prefix}.fn.fn.to_qkv", inner["to_qkv"])
    _conv(out, f"{prefix}.fn.fn.to_out", inner["to_out"])


def _cross_attention(out, prefix, prenorm, inner):
    _rms(out, f"{prefix}.fn.norm.g", prenorm["norm"])
    _conv(out, f"{prefix}.fn.fn.to_q", inner["to_q"])
    _dense(out, f"{prefix}.fn.fn.to_k", inner["to_k"])
    _dense(out, f"{prefix}.fn.fn.to_v", inner["to_v"])
    _conv(out, f"{prefix}.fn.fn.to_out", inner["to_out"])


def cfg_unet_state_from_jax(tree) -> Dict[str, torch.Tensor]:
    """vqgan_tpu CFGUnet params -> state dict of the port's CFGUnet."""
    p = _params(tree)
    out: Dict[str, torch.Tensor] = {
        "classes_emb.weight": _t(p["classes_emb"]["embedding"]),
        "null_classes_emb": _t(p["null_classes_emb"]),
    }
    _dense(out, "classes_mlp.0", p["Dense_0"])
    _dense(out, "classes_mlp.2", p["Dense_1"])
    if "sinu_pos_emb" in p:
        out["time_mlp.0.weights"] = _t(p["sinu_pos_emb"]["weights"])
    _dense(out, "time_mlp.1", p["Dense_2"])
    _dense(out, "time_mlp.3", p["Dense_3"])
    _conv(out, "init_conv", p["init_conv"])

    n_res = 0
    while f"down_{n_res}_block1" in p:
        n_res += 1
    for i in range(n_res):
        _film_resblock(out, f"downs.{i}.0", p[f"down_{i}_block1"])
        _film_resblock(out, f"downs.{i}.1", p[f"down_{i}_block2"])
        _linear_attention(out, f"downs.{i}.2", p[f"down_{i}_attn"],
                          p[f"LinearAttention_{i}"])
        _cross_attention(out, f"downs.{i}.3", p[f"down_{i}_cross_attn"],
                         p[f"CrossAttentionCond_{i}"])
        _conv(out, f"downs.{i}.4", p[f"down_{i}_downsample"])

    _film_resblock(out, "mid_block1", p["mid_block1"])
    _full_attention(out, "mid_attn", p["mid_attn"], p["Attention_0"])
    _cross_attention(out, "mid_cross_attn", p["mid_cross_attn"],
                     p[f"CrossAttentionCond_{n_res}"])
    _film_resblock(out, "mid_block2", p["mid_block2"])

    for i in range(n_res):
        _film_resblock(out, f"ups.{i}.0", p[f"up_{i}_block1"])
        _film_resblock(out, f"ups.{i}.1", p[f"up_{i}_block2"])
        _linear_attention(out, f"ups.{i}.2", p[f"up_{i}_attn"],
                          p[f"LinearAttention_{n_res + i}"])
        _cross_attention(out, f"ups.{i}.3", p[f"up_{i}_cross_attn"],
                         p[f"CrossAttentionCond_{n_res + 1 + i}"])
        up = p[f"up_{i}_upsample"]
        if "Conv_0" in up:  # nearest upsample + conv
            _conv(out, f"ups.{i}.4.1", up["Conv_0"])
        else:  # last resolution: plain 3x3 conv
            _conv(out, f"ups.{i}.4", up)

    _film_resblock(out, "final_res_block", p["final_res_block"])
    _conv(out, "final_conv", p["final_conv"])
    return out


# --- pixel-space denoisers: the DDPM U-Net and the Karras U-Net -------------


def _ddpm_attention(out, prefix, p):
    """`_LinearAttention` (with `out_norm`) or `_FullAttention`; mem_kv
    keeps its layout ([2, heads, dh, M] and [2, heads, M, dh])."""
    _rms(out, f"{prefix}.norm.g", p["norm"])
    _conv(out, f"{prefix}.to_qkv", p["to_qkv"])
    out[f"{prefix}.mem_kv"] = _t(p["mem_kv"])
    if "out_norm" in p:
        _conv(out, f"{prefix}.to_out.0", p["to_out"])
        _rms(out, f"{prefix}.to_out.1.g", p["out_norm"])
    else:
        _conv(out, f"{prefix}.to_out", p["to_out"])


def _conv_or_sequential(out, key, p):
    """A plain conv, or one behind a reshape or resize (`Conv_0` -> `.1`)."""
    if "Conv_0" in p:
        _conv(out, f"{key}.1", p["Conv_0"])
    else:
        _conv(out, key, p)


def ddpm_unet_state_from_jax(tree) -> Dict[str, torch.Tensor]:
    """vqgan_tpu Unet params -> state dict of the port's Unet:
    `down_{i}_block1` -> `downs.{i}.0`, `_block2` -> `.1`, `_attn` -> `.2`,
    `_downsample` -> `.3` (`.3.1` behind the space-to-depth), the same for
    `up_{i}` and `ups.{i}`; `Dense_0` / `Dense_1` -> `time_mlp.1` / `.3`."""
    p = _params(tree)
    out: Dict[str, torch.Tensor] = {}
    _conv(out, "init_conv", p["init_conv"])
    if "sinu_pos_emb" in p:
        out["time_mlp.0.weights"] = _t(p["sinu_pos_emb"]["weights"])
    # the time MLP's Dense layers are built in the Unet's scope, so flax
    # names them there
    _dense(out, "time_mlp.1", p["Dense_0"])
    _dense(out, "time_mlp.3", p["Dense_1"])
    n_stages = sum(key.endswith("_block1") and key.startswith("down_")
                   for key in p)
    for side, torch_side in (("down", "downs"), ("up", "ups")):
        for i in range(n_stages):
            prefix = f"{torch_side}.{i}"
            _film_resblock(out, f"{prefix}.0", p[f"{side}_{i}_block1"])
            _film_resblock(out, f"{prefix}.1", p[f"{side}_{i}_block2"])
            _ddpm_attention(out, f"{prefix}.2", p[f"{side}_{i}_attn"])
            resample = "downsample" if side == "down" else "upsample"
            _conv_or_sequential(out, f"{prefix}.3",
                                p[f"{side}_{i}_{resample}"])
    _film_resblock(out, "mid_block1", p["mid_block1"])
    _ddpm_attention(out, "mid_attn", p["mid_attn"])
    _film_resblock(out, "mid_block2", p["mid_block2"])
    _film_resblock(out, "final_res_block", p["final_res_block"])
    _conv(out, "final_conv", p["final_conv"])
    return out


def _karras_tree(out, prefix, p):
    for name, child in p.items():
        key = f"{prefix}{name}"
        if name == "mp_kernel":
            # MPConv [*k, in, out] or MPLinear [in, out] kernels
            out[f"{prefix}weight"] = _kernel(child)
        elif name in ("gain", "mem_kv", "weights"):
            out[key] = _t(child)
        else:
            _karras_tree(out, f"{key}.", child)


def karras_unet_state_from_jax(tree) -> Dict[str, torch.Tensor]:
    """vqgan_tpu KarrasUnet params (or those of an MPTransformer) -> state
    dict of the port's module: `mp_kernel` -> `weight` (HWIO -> OIHW,
    [in, out] -> [out, in]); `down_{i}` / `mid_{i}` / `up_{i}` / `attn_{i}`
    / `ff_{i}` -> `downs.{i}` / `mids.{i}` / `ups.{i}` / `attns.{i}` /
    `ffs.{i}`; every other name is kept."""
    flat: Dict[str, torch.Tensor] = {}
    _karras_tree(flat, "", _params(tree))
    plural = {"down": "downs", "mid": "mids", "up": "ups", "attn": "attns",
              "ff": "ffs"}
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        head, _, rest = key.partition(".")
        side, _, index = head.rpartition("_")
        if side in plural and index.isdigit():
            key = f"{plural[side]}.{index}.{rest}"
        out[key] = value
    return out


def karras_unet_nd_state_from_jax(tree) -> Dict[str, torch.Tensor]:
    """vqgan_tpu KarrasUnet1D / KarrasUnet3D params -> state dict of the
    port's: `mp_kernel` -> `weight` ([*k, in, out] -> [out, in, *k]),
    `down_{i}` / `mid_{i}` / `up_{i}` -> `downs.{i}` / `mids.{i}` /
    `ups.{i}`, a block's `attn` (or `attn_space`, `attn_time`) ->
    `attns.0` (`attns.0`, `attns.1`)."""
    attn = {"attn": "attns.0", "attn_space": "attns.0",
            "attn_time": "attns.1"}
    out: Dict[str, torch.Tensor] = {}
    for key, value in karras_unet_state_from_jax(tree).items():
        parts = key.split(".")
        if len(parts) > 2 and parts[2] in attn:
            parts[2] = attn[parts[2]]
        out[".".join(parts)] = value
    return out


def learned_log_snr_state_from_jax(tree) -> Dict[str, torch.Tensor]:
    """vqgan_tpu LearnedLogSNR params -> state dict of the port's
    (`lin{i}.kernel` [in, out] -> `lin{i}.weight` [out, in])."""
    p = _params(tree)
    out: Dict[str, torch.Tensor] = {}
    for name in ("lin1", "lin2", "lin3"):
        _dense(out, name, p[name])
    return out


def _time_mlp(out, p):
    """The learned-sinusoidal / sinusoidal embedding and the time MLP's
    Dense layers, which flax names in the model's own scope."""
    if "sinu_pos_emb" in p:
        out["time_mlp.0.weights"] = _t(p["sinu_pos_emb"]["weights"])
    _dense(out, "time_mlp.1", p["Dense_0"])
    _dense(out, "time_mlp.3", p["Dense_1"])


def _n_stages(p) -> int:
    return sum(key.startswith("down_") and key.endswith("_block1")
               for key in p)


def _uvit_resblock(out, prefix, p):
    _dense(out, f"{prefix}.mlp", p["mlp"])
    for i in (1, 2):
        _conv(out, f"{prefix}.proj{i}", p[f"proj{i}"])
        _rms(out, f"{prefix}.norm{i}.g", p[f"norm{i}"])
    if "res_conv" in p:
        _conv(out, f"{prefix}.res_conv", p["res_conv"])


def _plain_linear_attention(out, prefix, p, spatial_dims=2):
    _rms(out, f"{prefix}.norm.g", p["norm"], spatial_dims)
    _conv(out, f"{prefix}.to_qkv", p["to_qkv"])
    _conv(out, f"{prefix}.to_out", p["to_out"])


def _layernorm(out, key, p):
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])


def uvit_state_from_jax(tree) -> Dict[str, torch.Tensor]:
    """vqgan_tpu UViT params -> state dict of the port's UViT:
    `down_{i}_{block1,block2,attn,downsample}` -> `downs.{i}.{0-3}`,
    `up_{i}_{upsample,block1,block2,attn}` -> `ups.{i}.{0-3}`,
    `vit_{d}_attn` / `_ff` -> `vit_attns.{d}` / `vit_ffs.{d}`, the
    patch norms' scale -> weight, `unpatchify` with its taps flipped."""
    p = _params(tree)
    out: Dict[str, torch.Tensor] = {}
    if "init_conv" in p:
        _conv(out, "init_conv", p["init_conv"])
    else:
        _layernorm(out, "patch_norm_in", p["patch_norm_in"])
        _dense(out, "patch_proj", p["patch_proj"])
        _layernorm(out, "patch_norm_out", p["patch_norm_out"])
    _time_mlp(out, p)
    for i in range(_n_stages(p)):
        _uvit_resblock(out, f"downs.{i}.0", p[f"down_{i}_block1"])
        _uvit_resblock(out, f"downs.{i}.1", p[f"down_{i}_block2"])
        _plain_linear_attention(out, f"downs.{i}.2", p[f"down_{i}_attn"])
        _conv(out, f"downs.{i}.3", p[f"down_{i}_downsample"])
        _conv(out, f"ups.{i}.0", p[f"up_{i}_upsample"])
        _uvit_resblock(out, f"ups.{i}.1", p[f"up_{i}_block1"])
        _uvit_resblock(out, f"ups.{i}.2", p[f"up_{i}_block2"])
        _plain_linear_attention(out, f"ups.{i}.3", p[f"up_{i}_attn"])
    depth = sum(key.startswith("vit_") and key.endswith("_attn")
                for key in p)
    for d in range(depth):
        attn, ff = p[f"vit_{d}_attn"], p[f"vit_{d}_ff"]
        out[f"vit_attns.{d}.norm.g"] = _t(attn["norm"]["g"])
        _dense(out, f"vit_attns.{d}.to_qkv", attn["to_qkv"])
        _dense(out, f"vit_attns.{d}.to_out", attn["to_out"])
        out[f"vit_ffs.{d}.norm.g"] = _t(ff["norm"]["g"])
        for name in ("proj_in", "to_scale_shift", "proj_out"):
            _dense(out, f"vit_ffs.{d}.{name}", ff[name])
    _uvit_resblock(out, "final_res_block", p["final_res_block"])
    _conv(out, "final_conv", p["final_conv"])
    if "unpatchify" in p:
        _conv_transpose(out, "unpatchify", p["unpatchify"])
    return out


def _unet1d_resblock(out, prefix, p):
    _dense(out, f"{prefix}.mlp", p["mlp"])
    for block in ("block1", "block2"):
        _conv(out, f"{prefix}.{block}.proj", p[block]["proj"])
        _rms(out, f"{prefix}.{block}.norm.g", p[block]["_RMSNorm1D_0"], 1)
    if "res_conv" in p:
        _conv(out, f"{prefix}.res_conv", p["res_conv"])


def unet1d_state_from_jax(tree) -> Dict[str, torch.Tensor]:
    """vqgan_tpu Unet1D params -> state dict of the port's Unet1D:
    `{down,up}_{i}_{block1,block2,attn,downsample|upsample}` ->
    `{downs,ups}.{i}.{0-3}`, RMSNorm g [C] -> [1, C, 1]."""
    p = _params(tree)
    out: Dict[str, torch.Tensor] = {}
    _conv(out, "init_conv", p["init_conv"])
    _time_mlp(out, p)
    for side, torch_side, resample in (("down", "downs", "downsample"),
                                       ("up", "ups", "upsample")):
        for i in range(_n_stages(p)):
            prefix = f"{torch_side}.{i}"
            _unet1d_resblock(out, f"{prefix}.0", p[f"{side}_{i}_block1"])
            _unet1d_resblock(out, f"{prefix}.1", p[f"{side}_{i}_block2"])
            _plain_linear_attention(out, f"{prefix}.2",
                                    p[f"{side}_{i}_attn"], 1)
            _conv(out, f"{prefix}.3", p[f"{side}_{i}_{resample}"])
    _unet1d_resblock(out, "mid_block1", p["mid_block1"])
    _plain_linear_attention(out, "mid_attn", p["mid_attn"], 1)
    _unet1d_resblock(out, "mid_block2", p["mid_block2"])
    _unet1d_resblock(out, "final_res_block", p["final_res_block"])
    _conv(out, "final_conv", p["final_conv"])
    return out


# --- VQ-GAN: VQ-VAE, PatchGAN, LPIPS ----------------------------------------


def dit_state_from_jax(tree) -> Dict[str, torch.Tensor]:
    """vqgan_tpu DiT params -> state dict of the port's DiT: the patch
    convolution HWIO -> OIHW, every Dense [in, out] -> Linear [out, in],
    `blocks_{i}` -> `blocks.{i}`."""
    p = _params(tree)
    out = {"pos_emb": _t(p["pos_emb"]),
           "classes_emb.weight": _t(p["classes_emb"]["embedding"]),
           "null_classes_emb": _t(p["null_classes_emb"])}
    _conv(out, "patch_embed", p["patch_embed"])
    for name in ("time_mlp_in", "time_mlp_out", "final_mod", "final_proj"):
        _dense(out, name, p[name])
    depth = sum(key.startswith("blocks_") for key in p)
    for i in range(depth):
        for name in ("ada_mod", "to_qkv", "to_out", "mlp_in", "mlp_out"):
            _dense(out, f"blocks.{i}.{name}", p[f"blocks_{i}"][name])
    return out


def vqvae_state_from_jax(tree) -> Dict[str, torch.Tensor]:
    """vqgan_tpu VQVAE params -> state dict of the port's VQVAE."""
    p = _params(tree)
    out: Dict[str, torch.Tensor] = {}
    _encoder(out, p["encoder"])
    _decoder(out, p["decoder"])
    out["quantizer.embedding.weight"] = _t(p["quantizer"]["embedding"])
    if "pre_quant_conv" in p:
        _conv(out, "pre_quant_conv", p["pre_quant_conv"])
        _conv(out, "post_quant_conv", p["post_quant_conv"])
    return out


def patchgan_state_from_jax(variables) -> Dict[str, torch.Tensor]:
    """vqgan_tpu PatchGANDiscriminator variables -> state dict of the port's
    PatchGANDiscriminator, in the reference's `main` Sequential positions.
    The norm follows the variables: `batch_stats` (BatchNorm: scale/bias
    and the running mean/var), `actnorm_stats` (ActNorm's buffers), or
    neither (GroupNorm: scale/bias)."""
    p = _params(variables)
    stats = variables.get("batch_stats")
    act = variables.get("actnorm_stats")
    n_layers = sum(1 for k in p if k.startswith("conv_")) - 2
    out: Dict[str, torch.Tensor] = {}
    _conv(out, "main.0", p["conv_0"])
    for n in range(1, n_layers + 1):
        idx = 3 * n - 1
        _conv(out, f"main.{idx}", p[f"conv_{n}"])
        norm = f"main.{idx + 1}"
        if act is not None:
            a = act[f"norm_{n}"]
            out[f"{norm}.initialized"] = torch.tensor(
                int(np.asarray(a["initialized"])), dtype=torch.int32)
            out[f"{norm}.bias"] = _t(a["bias"])
            out[f"{norm}.weight"] = _t(a["weight"])
            continue
        out[f"{norm}.weight"] = _t(p[f"norm_{n}"]["scale"])
        out[f"{norm}.bias"] = _t(p[f"norm_{n}"]["bias"])
        if stats is not None:
            out[f"{norm}.running_mean"] = _t(stats[f"norm_{n}"]["mean"])
            out[f"{norm}.running_var"] = _t(stats[f"norm_{n}"]["var"])
    _conv(out, f"main.{3 * n_layers + 2}", p["conv_out"])
    return out


# Sequential positions of torchvision VGG16's convolutions in `features`
_VGG16_CONV_POSITIONS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def lpips_state_from_jax(tree) -> Dict[str, torch.Tensor]:
    """vqgan_tpu LPIPS params -> state dict of the port's LPIPS
    (`vgg.features.{i}.*`, `lin{i}.model.1.weight` [1, C, 1, 1])."""
    p = _params(tree)
    out: Dict[str, torch.Tensor] = {}
    for conv_idx, pos in enumerate(_VGG16_CONV_POSITIONS):
        _conv(out, f"vgg.features.{pos}", p["vgg"][f"conv_{conv_idx}"])
    for i in range(5):
        out[f"lin{i}.model.1.weight"] = _t(
            np.asarray(p[f"lin_{i}"]).reshape(1, -1, 1, 1))
    return out


# --- classifier and FID networks: ResNet, InceptionV3 -----------------------


def _batchnorm(out, key, p, stats):
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])
    out[f"{key}.running_mean"] = _t(stats["mean"])
    out[f"{key}.running_var"] = _t(stats["var"])


# (JAX conv, JAX norm, torch conv, torch norm) of a BasicBlock
_RESNET_BLOCK_LAYERS = (
    ("conv1", "bn1", "conv1", "bn1"),
    ("conv2", "bn2", "conv2", "bn2"),
    ("downsample_conv", "downsample_bn", "downsample.0", "downsample.1"),
)


def resnet_state_from_jax(variables) -> Dict[str, torch.Tensor]:
    """vqgan_tpu ResNet variables ({"params", "batch_stats"}) -> state dict
    of the port's ResNet (torchvision's names: `layer{i}_block{j}` ->
    `layer{i}.{j}`, `downsample_conv` / `downsample_bn` ->
    `downsample.0` / `.1`)."""
    p, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    _conv(out, "conv1", p["conv1"])
    _batchnorm(out, "bn1", p["bn1"], stats["bn1"])
    for name, block in p.items():
        if "_block" not in name:
            continue
        layer, j = name.split("_block")
        prefix = f"{layer}.{j}"
        for conv, bn, torch_conv, torch_bn in _RESNET_BLOCK_LAYERS:
            if conv in block:
                _conv(out, f"{prefix}.{torch_conv}", block[conv])
                _batchnorm(out, f"{prefix}.{torch_bn}", block[bn],
                           stats[name][bn])
    _dense(out, "fc", p["fc"])
    return out


def inception_state_from_jax(variables) -> Dict[str, torch.Tensor]:
    """vqgan_tpu InceptionV3Features variables ({"params",
    "batch_stats"}) -> state dict of the port's InceptionV3Features; the
    names are the same (torchvision's / pytorch-fid's), every BasicConv2d
    a `conv` and a `bn` (its `num_batches_tracked` 0)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(p, stats, path):
        if "conv" in p and "bn" in p:
            key = ".".join(path)
            _conv(out, f"{key}.conv", p["conv"])
            _batchnorm(out, f"{key}.bn", p["bn"], stats["bn"])
            out[f"{key}.bn.num_batches_tracked"] = torch.tensor(0)
            return
        for name, child in p.items():
            walk(child, stats[name], [*path, name])

    walk(variables["params"], variables["batch_stats"], [])
    return out
