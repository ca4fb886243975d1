"""Load weights into the port's models from PyTorch state-dict files.

The port's parameter names are the reference PyTorch models', so both the
port's own `state_dict()` files and the reference checkpoints load:
- a KL-VAE `kl_vae_best.pt` ({'model_state_dict': ...} or a raw state dict);
- a CFG U-Net state dict, raw, or inside a reference diffusion trainer
  checkpoint ({'ema': ...} preferred, else {'model': ...}; the
  'ema_model.' and 'model.' prefixes are stripped).
Orbax checkpoints of the JAX package (directories) need JAX to read; the
port refuses them with a message.
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn

__all__ = ["read_state_dict", "load_weights"]

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
