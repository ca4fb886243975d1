"""Load weights into the port's models from PyTorch state-dict files and
from the JAX package's Orbax checkpoints.

The port's parameter names are the reference PyTorch models', so both the
port's own `state_dict()` files and the reference checkpoints load:
- a KL-VAE `kl_vae_best.pt` ({'model_state_dict': ...} or a raw state dict);
- a CFG U-Net state dict, raw, or inside a reference diffusion trainer
  checkpoint ({'ema': ...} preferred, else {'model': ...}; the
  'ema_model.' and 'model.' prefixes are stripped);
- a VQ-VAE from a checkpoint of the port's VQ-GAN trainer (`vqgan-{m}.pt`
  with its config beside it) or a raw state dict (`load_vqvae`).
An Orbax checkpoint of the JAX package (a directory: a trainer's
milestone `model-{m}/`, `vqgan-{m}/`, or `train_kl_vae`'s `kl_vae-{m}/`)
loads wherever a file does: `orbax.read_orbax` reads the parameter
subtree the JAX CLIs read (`ema_params`, else `params`, else
`vqvae_params`, else the whole tree) and the `from_jax` converter of the
model's class maps it onto the module.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch
from torch import nn

from . import from_jax
from .orbax import read_orbax, top_level_keys
from ..configs.vqgan_config import VQGANConfig
from ..device import resolve_device
from ..diffusion.continuous_time import LearnedLogSNR
from ..models.autoencoder import KLVAE
from ..models.discriminator import PatchGANDiscriminator
from ..models.dit import DiT
from ..models.inception import InceptionV3Features
from ..models.karras_unet import KarrasUnet
from ..models.karras_unet_nd import KarrasUnet1D, KarrasUnet3D
from ..models.lpips import LPIPS
from ..models.resnet import ResNet
from ..models.unet import Unet
from ..models.unet1d import Unet1D
from ..models.unet_cfg import CFGUnet
from ..models.uvit import UViT
from ..models.vq_vae import VQVAE

__all__ = ["read_state_dict", "read_jax_params", "jax_state_for",
           "load_weights", "load_vqvae"]

_CONTAINERS = ("ema", "model", "model_state_dict", "state_dict")
_PREFIXES = ("ema_model.", "model.")
# the subtree the JAX CLIs load: cli/generate.py prefers the EMA weights;
# export_serving and diagnose_latent_range read a VQ-GAN's vqvae_params
_JAX_SUBTREES = ("ema_params", "params", "vqvae_params")


def read_state_dict(path) -> dict:
    """Tensors of a .pt file, unwrapped from the reference's containers,
    preferring EMA weights."""
    path = Path(path)
    if path.is_dir():
        raise ValueError(
            f"{path} is a directory, such as an Orbax checkpoint of the JAX "
            f"package, whose names are the JAX modules': load it into a "
            f"model with load_weights")
    state = torch.load(path, map_location="cpu", weights_only=True)
    for key in _CONTAINERS:
        if isinstance(state.get(key), dict):
            state = state[key]
            break
    for prefix in _PREFIXES:
        if any(k.startswith(prefix) for k in state):
            state = {k[len(prefix):]: v for k, v in state.items()
                     if k.startswith(prefix)}
    return {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}


def read_jax_params(path) -> dict:
    """The parameter tree (numpy) of an Orbax checkpoint directory, the
    subtree the JAX CLIs read: `ema_params`, else `params`, else
    `vqvae_params`, else the whole tree. Only that subtree is decompressed.
    Raises for a directory that is not an Orbax checkpoint."""
    keys = top_level_keys(path)
    for name in _JAX_SUBTREES:
        if name in keys:
            return read_orbax(path, select=(name,))[name]
    return read_orbax(path)


# each port class with the from_jax converter of its JAX counterpart
_CONVERTERS = (
    (KLVAE, from_jax.klvae_state_from_jax),
    (CFGUnet, from_jax.cfg_unet_state_from_jax),
    (DiT, from_jax.dit_state_from_jax),
    (VQVAE, from_jax.vqvae_state_from_jax),
    (Unet, from_jax.ddpm_unet_state_from_jax),
    (KarrasUnet, from_jax.karras_unet_state_from_jax),
    (KarrasUnet1D, from_jax.karras_unet_nd_state_from_jax),
    (KarrasUnet3D, from_jax.karras_unet_nd_state_from_jax),
    (UViT, from_jax.uvit_state_from_jax),
    (Unet1D, from_jax.unet1d_state_from_jax),
    (LearnedLogSNR, from_jax.learned_log_snr_state_from_jax),
    (PatchGANDiscriminator, from_jax.patchgan_state_from_jax),
    (LPIPS, from_jax.lpips_state_from_jax),
    (ResNet, from_jax.resnet_state_from_jax),
    (InceptionV3Features, from_jax.inception_state_from_jax),
)


def jax_state_for(model: nn.Module, tree) -> dict:
    """`tree`, a JAX module's parameters, as a state dict of `model`, by
    the converter of the model's class."""
    for cls, convert in _CONVERTERS:
        if isinstance(model, cls):
            return convert(tree)
    raise TypeError(f"no converter from the JAX package's parameters to a "
                    f"{type(model).__name__}")


def load_weights(model: nn.Module, path) -> nn.Module:
    """Load `path`, a state-dict file or an Orbax checkpoint directory, into
    `model`. Every parameter of the model must be present and of its shape;
    entries the model does not have (a trainer's schedule buffers, an EMA
    step count) are ignored."""
    if Path(path).is_dir():
        state = jax_state_for(model, read_jax_params(path))
    else:
        state = read_state_dict(path)
    wanted = model.state_dict().keys()
    missing = [k for k in wanted if k not in state]
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} of the model's "
                       f"parameters, e.g. {missing[:3]}")
    model.load_state_dict({k: state[k] for k in wanted})
    return model


def load_vqvae(path, image_size: int | None = None, device="cuda"):
    """(VQVAE in eval mode on `device`, its VQGANConfig) from `path`: a
    checkpoint of the port's VQ-GAN trainer (`vqgan-{m}.pt`, whose "vqvae"
    entry is the VQ-VAE's state) or of the JAX package's (the Orbax
    directory `vqgan-{m}/`, whose `vqvae_params` are read), with
    `vqgan-{m}.config.json` beside it, or a raw VQ-VAE state dict, which
    gets the VQ-VAE's default widths in fp32, as the JAX package's tools
    build it. `image_size` overrides the config's."""
    device = resolve_device(device)
    path = Path(path)
    config_file = path.with_name(f"{path.stem}.config.json")
    raw = (json.loads(config_file.read_text()) if config_file.exists()
           else {"compute_dtype": "float32"})
    if image_size is not None:
        raw["image_size"] = image_size
    cfg = VQGANConfig.from_dict(raw)
    if path.is_dir():
        state = from_jax.vqvae_state_from_jax(read_jax_params(path))
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(state.get("vqvae"), dict):
            state = state["vqvae"]
    vqvae = VQVAE(
        ch=cfg.ch, ch_mult=cfg.ch_mult, num_res_blocks=cfg.num_res_blocks,
        attn_resolutions=cfg.attn_resolutions, dropout=cfg.dropout,
        resolution=cfg.image_size,
        z_channels=cfg.z_channels, num_embeddings=cfg.num_embeddings,
        embedding_dim=cfg.embedding_dim, commitment_cost=cfg.commitment_cost,
        out_channels=cfg.out_channels,
        dtype=(torch.bfloat16 if cfg.compute_dtype == "bfloat16"
               else torch.float32))
    vqvae.load_state_dict(state)
    return vqvae.to(device).eval(), cfg
