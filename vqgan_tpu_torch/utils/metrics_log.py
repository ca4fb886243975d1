"""Structured metrics logging: the JSONL stream of
vqgan_tpu/utils/metrics_log.py.

An append-only JSONL file, one object per logged step.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self, log_dir: str | Path, run_name: str = "train"):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.log_dir / f"{run_name}.jsonl"
        self._file = open(self.path, "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float]):
        rec = {"step": int(step), "wall_s": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def close(self):
        self._file.close()
