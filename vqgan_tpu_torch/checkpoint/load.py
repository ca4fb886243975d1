"""Load weights into the port's models from PyTorch state-dict files.

The port's parameter names are the reference PyTorch models', so both the
port's own `state_dict()` files and the reference checkpoints load:
- a KL-VAE `kl_vae_best.pt` ({'model_state_dict': ...} or a raw state dict);
- a CFG U-Net state dict, raw, or inside a reference diffusion trainer
  checkpoint ({'ema': ...} preferred, else {'model': ...}; the
  'ema_model.' and 'model.' prefixes are stripped);
- a VQ-VAE from a checkpoint of the port's VQ-GAN trainer (`vqgan-{m}.pt`
  with its config beside it) or a raw state dict (`load_vqvae`).
Orbax checkpoints of the JAX package (directories) need JAX to read; the
port refuses them with a message.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch
from torch import nn

from ..configs.vqgan_config import VQGANConfig
from ..device import resolve_device
from ..models.vq_vae import VQVAE

__all__ = ["read_state_dict", "load_weights", "load_vqvae"]

_CONTAINERS = ("ema", "model", "model_state_dict", "state_dict")
_PREFIXES = ("ema_model.", "model.")


def read_state_dict(path) -> dict:
    """Tensors of a .pt file, unwrapped from the reference's containers,
    preferring EMA weights."""
    path = Path(path)
    if path.is_dir():
        raise ValueError(
            f"{path} is a directory, such as an Orbax checkpoint of the JAX "
            f"package; the port reads PyTorch state-dict files (.pt)")
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


def load_weights(model: nn.Module, path) -> nn.Module:
    """Load `path` into `model`. Every parameter of the model must be
    present; entries the model does not have (a trainer's schedule buffers,
    an EMA step count) are ignored."""
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
    entry is the VQ-VAE's state, with `vqgan-{m}.config.json` beside it),
    or a raw VQ-VAE state dict, which gets the VQ-VAE's default widths in
    fp32, as the JAX package's tools build it. `image_size` overrides the
    config's."""
    device = resolve_device(device)
    path = Path(path)
    config_file = path.with_name(f"{path.stem}.config.json")
    raw = (json.loads(config_file.read_text()) if config_file.exists()
           else {"compute_dtype": "float32"})
    if image_size is not None:
        raw["image_size"] = image_size
    cfg = VQGANConfig.from_dict(raw)
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state.get("vqvae"), dict):
        state = state["vqvae"]
    vqvae = VQVAE(
        ch=cfg.ch, ch_mult=cfg.ch_mult, num_res_blocks=cfg.num_res_blocks,
        attn_resolutions=cfg.attn_resolutions, resolution=cfg.image_size,
        z_channels=cfg.z_channels, num_embeddings=cfg.num_embeddings,
        embedding_dim=cfg.embedding_dim, commitment_cost=cfg.commitment_cost,
        out_channels=cfg.out_channels,
        dtype=(torch.bfloat16 if cfg.compute_dtype == "bfloat16"
               else torch.float32))
    vqvae.load_state_dict(state)
    return vqvae.to(device).eval(), cfg
