"""Downstream classifier harness: does synthetic data improve per-user
identification accuracy? (The project's acceptance metric.)

Counterpart of vqgan_tpu/eval/classifier.py (the reference's
classifier_experiment_example.py and classifier_multi_seed_experiment.py):
- `ClassifierExperiment`: ResNet18 from scratch (flax's default
  initialisation from `seed`), Adam at optax's defaults (b1 0.9, b2
  0.999, eps 1e-8, no decay), mean cross-entropy, the BatchNorm running
  statistics updated in each training forward. `train` draws batches from
  one `BatchLoader(shuffle=True, seed=seed, drop_last=True)`, whose
  generator carries on across epochs, so the same seed gives the JAX
  package's batches. `evaluate` reports accuracy, per-class accuracy
  (keyed by the int label), mean confidence and the two over-confidence
  warnings.
- `run_multi_seed`: the experiment per seed ({6, 42, 888}), aggregated to
  mean / std / min / max and written to JSON.
Batches are NHWC numpy on the host, moved to `device` and to NCHW there.
The JAX harness's `image_size` argument only shaped its init's dummy
input; the port's model needs none, so it has no such argument.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..data.datasets import BatchLoader
from ..device import resolve_device
from ..models.resnet import ResNet18

__all__ = ["ClassifierExperiment", "DEFAULT_SEEDS", "accuracy_report",
           "run_multi_seed"]

DEFAULT_SEEDS = (6, 42, 888)


def accuracy_report(preds: np.ndarray, labels: np.ndarray,
                    conf: np.ndarray) -> Dict:
    """Accuracy, per-class accuracy, mean confidence and the warnings of
    an over-confident model (mean confidence over 0.99; wrong predictions
    at a mean confidence over 0.9)."""
    acc = float((preds == labels).mean())
    per_class = {}
    for c in np.unique(labels):
        mask = labels == c
        per_class[int(c)] = float((preds[mask] == labels[mask]).mean())

    warnings = []
    mean_conf = float(conf.mean())
    if mean_conf > 0.99:
        warnings.append(
            f"mean confidence {mean_conf:.3f} suspiciously high — "
            f"possible overfit")
    high_conf_wrong = float(conf[preds != labels].mean()) \
        if (preds != labels).any() else 0.0
    if high_conf_wrong > 0.9:
        warnings.append(
            f"wrong predictions still confident ({high_conf_wrong:.3f})")

    return {
        "accuracy": acc,
        "per_class_accuracy": per_class,
        "mean_confidence": mean_conf,
        "n_samples": int(len(labels)),
        "warnings": warnings,
    }


class ClassifierExperiment:
    def __init__(self, num_classes: int = 31, lr: float = 1e-4,
                 epochs: int = 15, batch_size: int = 64, seed: int = 42,
                 device="cuda"):
        self.num_classes = num_classes
        self.lr = lr
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.device = resolve_device(device)
        self.model = ResNet18(
            num_classes, generator=torch.Generator().manual_seed(seed)
        ).to(self.device)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=lr)
        # per epoch: {"losses", "accuracies", "images", "seconds"}, the
        # seconds of the whole epoch with the device synchronised at both
        # ends
        self.history = []

    def _to_device(self, images, labels):
        x = torch.as_tensor(images).to(self.device)
        y = torch.as_tensor(labels).to(self.device).long()
        return x.permute(0, 3, 1, 2).contiguous(), y

    def train_step(self, images, labels):
        """One Adam step on an NHWC batch (numpy, or tensors on any
        device); (loss, accuracy) as device tensors."""
        x, y = self._to_device(images, labels)
        self.model.train()
        logits = self.model(x)
        loss = F.cross_entropy(logits, y)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        acc = (logits.argmax(-1) == y).float().mean()
        return loss.detach(), acc.detach()

    def _synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, dataset, verbose: bool = True):
        loader = BatchLoader(dataset, self.batch_size, shuffle=True,
                             seed=self.seed, drop_last=True)
        for epoch in range(self.epochs):
            self._synchronize()
            t0 = time.perf_counter()
            steps = [self.train_step(images, labels)
                     for images, labels in loader]
            losses = [float(loss) for loss, _ in steps]
            accs = [float(acc) for _, acc in steps]
            self._synchronize()
            seconds = time.perf_counter() - t0
            self.history.append({"losses": losses, "accuracies": accs,
                                 "images": len(steps) * self.batch_size,
                                 "seconds": seconds})
            if verbose:
                print(f"epoch {epoch + 1}/{self.epochs}: "
                      f"loss={np.mean(losses):.4f} acc={np.mean(accs):.3f} "
                      f"({seconds:.1f}s)")
        return self

    def evaluate(self, dataset) -> Dict:
        """`accuracy_report` of the model's predictions on `dataset`."""
        loader = BatchLoader(dataset, self.batch_size, shuffle=False,
                             drop_last=False)
        self.model.eval()
        all_preds, all_labels, all_conf = [], [], []
        with torch.inference_mode():
            for images, labels in loader:
                x, _ = self._to_device(images, labels)
                probs = torch.softmax(self.model(x), dim=-1).cpu().numpy()
                all_preds.append(probs.argmax(-1))
                all_conf.append(probs.max(-1))
                all_labels.append(labels)
        return accuracy_report(np.concatenate(all_preds),
                               np.concatenate(all_labels),
                               np.concatenate(all_conf))


def run_multi_seed(
    make_train_dataset,
    make_test_dataset,
    seeds: Sequence[int] = DEFAULT_SEEDS,
    output_path: Optional[str] = None,
    **experiment_kwargs,
) -> Dict:
    """Repeat the experiment per seed; aggregate mean/std/min/max."""
    results = []
    for seed in seeds:
        print(f"--- seed {seed} ---")
        exp = ClassifierExperiment(seed=seed, **experiment_kwargs)
        exp.train(make_train_dataset())
        res = exp.evaluate(make_test_dataset())
        res["seed"] = seed
        results.append(res)
        print(f"seed {seed}: accuracy {res['accuracy']:.4f}")

    accs = np.array([r["accuracy"] for r in results])
    summary = {
        "seeds": list(seeds),
        "accuracies": accs.tolist(),
        "mean": float(accs.mean()),
        "std": float(accs.std()),
        "min": float(accs.min()),
        "max": float(accs.max()),
        "per_seed": results,
    }
    if output_path:
        Path(output_path).parent.mkdir(parents=True, exist_ok=True)
        Path(output_path).write_text(json.dumps(summary, indent=2))
    print(f"multi-seed accuracy: {summary['mean']:.4f} ± {summary['std']:.4f} "
          f"(min {summary['min']:.4f}, max {summary['max']:.4f})")
    return summary
