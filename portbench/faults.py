"""Faults planted under the timed path, to show that `correct` catches
them: each is a context manager that patches the program for the run
inside it. The tests run them on the CPU at small sizes; `proof.py` runs
them on the chip at the cells' own sizes.

- "frozen_state": every optimizer step returns the state unchanged;
- "half_batch": each step sees the first half of its batch only, the
  mean taken over the rest;
- "altered_answer": one image of every generated request is altered
  where it is produced (the decode).

A driver takes a fault's name (`run(ctx, device, fault=...)`) and plants
it in the process that runs the program. `CONTROL` ("control") patches
nothing: the driver puts the reference, computed in the nearest precision
below the configuration's, in the place of the program's readings.
"""

from __future__ import annotations

import contextlib
from unittest import mock

__all__ = ["CONTROL", "FAULTS", "TRAINING_FAULTS", "fault"]

TRAINING_FAULTS = ("frozen_state", "half_batch")
FAULTS = (*TRAINING_FAULTS, "altered_answer")
CONTROL = "control"


@contextlib.contextmanager
def fault(name):
    """The program patched with fault `name` inside the block; None
    patches nothing."""
    from vqgan_tpu_torch.models.autoencoder import KLVAE
    from vqgan_tpu_torch.training.ldm_step import CapturableOptimizer
    from vqgan_tpu_torch.training.ldm_trainer import LatentDiffusionTrainer
    from vqgan_tpu_torch.training.vqgan_trainer import VQGANTrainer

    if name is None or name == CONTROL:
        yield
    elif name == "frozen_state":
        def frozen(self, grads, norm=None, active=None):
            self.zero_grad()

        with mock.patch.object(CapturableOptimizer, "step", frozen):
            yield
    elif name == "half_batch":
        vq_block = VQGANTrainer.dispatch_block
        ldm_block = LatentDiffusionTrainer.dispatch_block

        def vq_half(self, superbatch, step):
            return vq_block(self, superbatch[:, :superbatch.shape[1] // 2],
                            step)

        def ldm_half(self, latents, labels):
            half = latents.shape[1] // 2
            return ldm_block(self, latents[:, :half], labels[:, :half])

        with mock.patch.object(VQGANTrainer, "dispatch_block", vq_half), \
                mock.patch.object(LatentDiffusionTrainer, "dispatch_block",
                                  ldm_half):
            yield
    elif name == "altered_answer":
        decode = KLVAE.decode_latents

        def altered(self, z):
            images = decode(self, z).clone()
            images[0] = 1.0 - images[0]
            return images

        with mock.patch.object(KLVAE, "decode_latents", altered):
            yield
    else:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")
