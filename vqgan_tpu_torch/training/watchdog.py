"""Host-side training-health watchdog: a copy of
vqgan_tpu/training/watchdog.py.

A NaN/Inf strike counter that raises after 3 consecutive bad steps, a
persistent-high-loss warning, plateau detection and a too-low-loss warning,
plus the sampled-image range check. It runs on the host over scalars already
fetched from the device; it never blocks the step stream.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = ["TrainingDiverged", "TrainingWatchdog", "check_sample_range"]


class TrainingDiverged(RuntimeError):
    pass


class TrainingWatchdog:
    def __init__(
        self,
        nan_strikes: int = 3,
        high_loss_threshold: float = 1.0,
        high_loss_after_step: int = 1000,
        plateau_window: int = 500,
        plateau_rel_change: float = 0.01,
        overfit_loss_floor: float = 1e-3,
    ):
        self.nan_strikes = nan_strikes
        self.high_loss_threshold = high_loss_threshold
        self.high_loss_after_step = high_loss_after_step
        self.plateau_window = plateau_window
        self.plateau_rel_change = plateau_rel_change
        self.overfit_loss_floor = overfit_loss_floor

        self._nan_count = 0
        self.loss_history: List[float] = []
        self.warnings: List[str] = []

    def check(self, step: int, loss: float) -> List[str]:
        """Record one step. Raises TrainingDiverged after `nan_strikes`
        consecutive non-finite losses; returns any new warnings."""
        new_warnings = []

        if not np.isfinite(loss):
            self._nan_count += 1
            new_warnings.append(
                f"step {step}: non-finite loss ({loss}) "
                f"[{self._nan_count}/{self.nan_strikes}]")
            if self._nan_count >= self.nan_strikes:
                raise TrainingDiverged(
                    f"training diverged: {self.nan_strikes} consecutive "
                    f"non-finite losses at step {step}")
            self.warnings += new_warnings
            return new_warnings
        self._nan_count = 0
        self.loss_history.append(float(loss))

        if step > self.high_loss_after_step and loss > self.high_loss_threshold:
            new_warnings.append(
                f"step {step}: loss {loss:.3f} still above "
                f"{self.high_loss_threshold} after step "
                f"{self.high_loss_after_step}")

        w = self.plateau_window
        if len(self.loss_history) >= 2 * w:
            recent = np.mean(self.loss_history[-w:])
            prev = np.mean(self.loss_history[-2 * w : -w])
            if prev > 0 and abs(prev - recent) / prev < self.plateau_rel_change:
                new_warnings.append(
                    f"step {step}: loss plateaued "
                    f"({prev:.4f} → {recent:.4f} over {w} steps)")

        if 0 < loss < self.overfit_loss_floor:
            new_warnings.append(
                f"step {step}: loss {loss:.2e} suspiciously low — possible "
                f"overfit/leak")

        self.warnings += new_warnings
        return new_warnings


def check_sample_range(images: np.ndarray, lo: float = 0.0, hi: float = 1.0
                       ) -> Optional[str]:
    """A warning when sampled images leave [lo, hi] or are nearly constant;
    None when they look sane."""
    mn, mx = float(np.min(images)), float(np.max(images))
    if mn < lo - 0.05 or mx > hi + 0.05:
        return (f"sampled images out of range: [{mn:.3f}, {mx:.3f}] vs "
                f"expected [{lo}, {hi}]")
    if mx - mn < 0.01:
        return f"sampled images nearly constant (range {mx - mn:.2e})"
    return None
