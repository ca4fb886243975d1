"""Checkpoints: the milestone + latest layout with `torch.save`.

Counterpart of vqgan_tpu/checkpoint/manager.py. Milestone `m` is the file
`{prefix}-{m}.pt` (a dict the trainer composes: step, model, EMA and
optimizer state), its config `{prefix}-{m}.config.json`, and the pointer
`{prefix}-latest.json` names the newest. The JAX package writes Orbax
directories `{prefix}-{m}/` in the same place; the port cannot read those
and says so.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional

import torch

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
        out = []
        for p in self.directory.glob(f"{self.prefix}-*.pt"):
            suffix = p.stem.rsplit("-", 1)[-1]
            if suffix.isdigit():
                out.append(int(suffix))
        return sorted(out)

    def latest_milestone(self) -> Optional[int]:
        p = self._latest_pointer()
        if p.exists():
            return json.loads(p.read_text())["milestone"]
        milestones = self.all_milestones()
        return milestones[-1] if milestones else None

    def checked_path(self, milestone: Optional[int] = None) -> Path:
        """The file of `milestone` (the latest when None). Raises where there
        is none, with a message where an Orbax directory stands instead."""
        if milestone is None:
            milestone = self.latest_milestone()
            if milestone is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}")
        path = self.path(milestone)
        if not path.exists() and path.with_suffix("").is_dir():
            raise ValueError(
                f"{path.with_suffix('')} is an Orbax checkpoint of the JAX "
                f"package; the port reads only its own {self.prefix}-*.pt "
                f"checkpoints")
        if not path.exists():
            raise FileNotFoundError(path)
        return path

    def restore(self, milestone: Optional[int] = None,
                map_location="cpu") -> Dict[str, Any]:
        """The state saved at `milestone` (the latest when None)."""
        return torch.load(self.checked_path(milestone),
                          map_location=map_location, weights_only=True)

    def load_config(self, milestone: Optional[int] = None) -> Optional[Dict]:
        if milestone is None:
            milestone = self.latest_milestone()
        p = self.directory / f"{self.prefix}-{milestone}.config.json"
        return json.loads(p.read_text()) if p.exists() else None
