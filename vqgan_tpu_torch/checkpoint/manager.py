"""Checkpoints: the milestone + latest layout with `torch.save`.

Counterpart of vqgan_tpu/checkpoint/manager.py. Milestone `m` is the file
`{prefix}-{m}.pt` (a dict the trainer composes: step, model, EMA and
optimizer state), its config `{prefix}-{m}.config.json`, and the pointer
`{prefix}-latest.json` names the newest. The JAX package writes Orbax
directories `{prefix}-{m}/` in the same place with the same config and
pointer files; they count as milestones here, and `checked_path` returns
such a directory, which `load.load_weights` reads. `restore`, the
trainers' resume, reads one given the train state it resumes: the JAX
train state (its optax state included) comes back in that state's own
`state_dict()` form (`train_state.train_state_from_jax`).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from .orbax import is_orbax_checkpoint, read_orbax
from .train_state import train_state_from_jax

__all__ = ["CheckpointManager"]


class CheckpointManager:
    def __init__(self, directory: str | Path, prefix: str = "model"):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.prefix = prefix

    def path(self, milestone: int | str) -> Path:
        return self.directory / f"{self.prefix}-{milestone}.pt"

    def _latest_pointer(self) -> Path:
        return self.directory / f"{self.prefix}-latest.json"

    def save(self, milestone: int, state: Dict[str, Any],
             config: Optional[Dict] = None) -> Path:
        """Write milestone `milestone` (replacing it) and point latest at it.
        The file is written under a temporary name and renamed, so a
        milestone is never half written."""
        path = self.path(milestone)
        tmp = path.with_suffix(".pt.tmp")
        torch.save(state, tmp)
        os.replace(tmp, path)
        if config is not None:
            (self.directory / f"{self.prefix}-{milestone}.config.json"
             ).write_text(json.dumps(config, default=str, indent=2))
        self._latest_pointer().write_text(json.dumps({"milestone": milestone}))
        return path

    def all_milestones(self):
        """Every milestone, as a .pt file of the port or an Orbax directory
        of the JAX package. Raises where one milestone has both."""
        files, dirs = set(), set()
        for p in self.directory.glob(f"{self.prefix}-*"):
            suffix = p.name[len(self.prefix) + 1:]
            if p.is_dir() and suffix.isdigit():
                dirs.add(int(suffix))
            elif p.suffix == ".pt" and suffix[:-3].isdigit():
                files.add(int(suffix[:-3]))
        if files & dirs:
            raise self._both_forms(min(files & dirs))
        return sorted(files | dirs)

    def _both_forms(self, milestone: int) -> ValueError:
        path = self.path(milestone)
        return ValueError(f"milestone {milestone} is both {path} and the "
                          f"Orbax directory {path.with_suffix('')}; remove "
                          f"one")

    def latest_milestone(self) -> Optional[int]:
        p = self._latest_pointer()
        if p.exists():
            return json.loads(p.read_text())["milestone"]
        milestones = self.all_milestones()
        return milestones[-1] if milestones else None

    def checked_path(self, milestone: Optional[int] = None) -> Path:
        """The .pt file or the Orbax directory of `milestone` (the latest
        when None). Raises where there is none, or both."""
        if milestone is None:
            milestone = self.latest_milestone()
            if milestone is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}")
        path = self.path(milestone)
        orbax_dir = path.with_suffix("")
        if path.exists() and orbax_dir.is_dir():
            raise self._both_forms(milestone)
        if orbax_dir.is_dir():
            return orbax_dir
        if not path.exists():
            raise FileNotFoundError(path)
        return path

    def restore(self, milestone: Optional[int] = None, map_location="cpu",
                state=None) -> Dict[str, Any]:
        """The state saved at `milestone` (the latest when None). An Orbax
        directory of the JAX package comes back as `state.state_dict()`
        would give it: `state` is the train state that resumes it (an
        `LDMTrainState`, `VQGANTrainState` or `ShardedState`), and the
        call raises without one, or for a directory Orbax did not write."""
        path = self.checked_path(milestone)
        if path.is_dir():
            if not is_orbax_checkpoint(path):
                raise ValueError(f"{path} is a directory but not an Orbax "
                                 f"checkpoint (no _METADATA)")
            if state is None:
                raise ValueError(
                    f"{path} is an Orbax checkpoint of the JAX package: "
                    f"restore(state=) maps its train state onto the port "
                    f"state that resumes it")
            return train_state_from_jax(read_orbax(path), state)
        return torch.load(path, map_location=map_location, weights_only=True)

    def load_config(self, milestone: Optional[int] = None) -> Optional[Dict]:
        if milestone is None:
            milestone = self.latest_milestone()
        p = self.directory / f"{self.prefix}-{milestone}.config.json"
        return json.loads(p.read_text()) if p.exists() else None
