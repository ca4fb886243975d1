"""Latent-diffusion training in scan mode: `LatentDiffusionTrainer` with
`step_mode="scan"` (the CFG U-Net in bf16, pred_v with min-SNR weighting,
clipped AdamW, the device-step EMA), one step's CUDA graph replayed per
step; latents [B, 32, 32, 4] and class labels of a seeded host pool fed
through `data/prefetch.device_prefetch`; t and the noise drawn by the
trainer from its generator, which the benchmark seeds; each block's
losses read one dispatch late.

Traffic parameters: scan_block, pool (latents in the host pool),
start_step (the trainer's step count at the first step: past the EMA's
warm-up, so that one of the three checked steps updates the EMA),
trace_blocks.

After the window the reference (`reference/ldm.py`, float32) takes the
first three steps from the same weights, latents, labels and draws. With
the fault `faults.CONTROL` the reference in float8 takes the program's
place.
"""

from __future__ import annotations

import torch

from .. import compare, faults, inputs
from ..harness import Check, Context, Record, mark, seed_for
from ..reference.layers import Precision, float32_math
from ..reference.ldm import (
    LDMReference,
    draw_step_noise,
    unet_spec,
    unet_step_flops,
)
from ..training import CHECKED, Trainee, run_training
from ..weights import load_into, make_weights

__all__ = ["run", "reference_readings", "numbers"]


class _LDM(Trainee):
    def __init__(self, ctx: Context, device):
        from vqgan_tpu_torch.configs.ldm_config import LDMConfig
        from vqgan_tpu_torch.data.prefetch import device_prefetch, to_device
        from vqgan_tpu_torch.training.ldm_trainer import (
            LatentDiffusionTrainer,
        )
        mark(ctx, "program imported")
        p = ctx.traffic
        cfg = LDMConfig.from_dict({
            **ctx.config, "results_folder": str(ctx.scratch / "ldm"),
            "seed": seed_for(ctx.seed, "program") % 2 ** 31})
        self.trainer = t = LatentDiffusionTrainer(
            cfg, device=device, step_mode="scan", scan_block=p["scan_block"])
        mark(ctx, "trainer built")
        weights = make_weights({"unet": unet_spec(ctx.config)},
                               seed_for(ctx.seed, "weights"), t.device)
        load_into(t.model, weights["unet"])
        load_into(t.ema_model, weights["unet"])
        del weights
        mark(ctx, "seeded weights loaded")
        t.generator.manual_seed(seed_for(ctx.seed, "draws"))
        t.state.step = p["start_step"]
        self.batch = cfg.train_batch_size
        pool = inputs.latent_pool(p["pool"], cfg.latent_size,
                                  cfg.latent_channels, cfg.num_users,
                                  seed_for(ctx.seed, "inputs"))
        feed = inputs.batches(pool, cfg.train_batch_size,
                              seed_for(ctx.seed, "order"))
        self.batches = device_prefetch(feed, lambda b: (
            to_device(b[0], t.device),
            to_device(b[1], t.device, torch.long)), depth=2)
        self.names = [f"model.{n}" for n, q in t.model.named_parameters()
                      if q.requires_grad]

    def dispatch(self, drawn):
        return self.trainer.dispatch_block(
            torch.stack([d[1][0] for d in drawn]),
            torch.stack([d[1][1] for d in drawn]))

    def losses(self, logs):
        return {"loss": logs["loss"]}

    def fed_grads(self):
        opt = self.trainer.optimizer
        b1 = opt.betas[0]
        return {n: m / (1.0 - b1) for n, m in zip(self.names, opt.exp_avg)}

    def leaves(self):
        t = self.trainer
        out = {f"model.{n}": q for n, q in t.model.named_parameters()}
        out.update({f"ema.{n}": q for n, q in t.ema_model.named_parameters()})
        return out

    def graph_capture_s(self):
        return sum(st["capture_seconds"] or 0.0
                   for st in self.trainer.graph_stats())

    def close(self):
        self.batches.close()
        self.batches = self.trainer = None


def reference_readings(ctx: Context, host_batches, precision: str,
                       device) -> dict:
    """The reference's first `CHECKED` steps on the program's host batches
    with the trainer's draws: {"losses", "grads", "leaves", "start"}."""
    cfg = ctx.config
    with float32_math():
        weights = make_weights({"unet": unet_spec(cfg)},
                               seed_for(ctx.seed, "weights"), device)["unet"]
        ref = LDMReference(cfg, weights, Precision(precision), device)
        gen = torch.Generator(device=device).manual_seed(
            seed_for(ctx.seed, "draws"))
        shape = (cfg["latent_channels"], cfg["latent_size"],
                 cfg["latent_size"])
        losses, grads = [], None
        for i, (latents, labels) in enumerate(host_batches[:CHECKED]):
            t, noise = draw_step_noise(gen, cfg["timesteps"], len(labels),
                                       shape, device)
            out = ref.step(torch.as_tensor(latents, device=device),
                           torch.as_tensor(labels, device=device), t, noise,
                           ctx.traffic["start_step"] + i)
            losses.append(out["loss"])
            if grads is None:
                grads = {f"model.{k}": v for k, v in out["grads"].items()}
        start = {f"model.{k}": v for k, v in weights.items()}
        start.update({f"ema.{k}": v for k, v in weights.items()})
        return {"losses": {"loss": losses}, "grads": grads,
                "leaves": ref.params(), "start": start}


def numbers(program: dict, reference: dict) -> dict:
    """{"loss", "grad", "move"} (see `compare.py`), each (value, where);
    an EMA leaf is left out of "move" where its weight's is."""
    loss = compare.loss_gap(program["losses"]["loss"],
                            reference["losses"]["loss"])
    grad = compare.leaf_gap(program["grads"], reference["grads"])
    quiet = compare.quiet_leaves(reference["grads"])
    quiet |= {"ema." + k[len("model."):] for k in quiet}
    start = reference["start"]
    moved_p = {k: program["leaves"][k].float() - start[k]
               for k in reference["leaves"] if k in program["leaves"]}
    moved_r = {k: v - start[k] for k, v in reference["leaves"].items()}
    move = compare.leaf_gap(moved_p, moved_r, quiet)
    return {"loss": (loss, "steps 1-3"), "grad": grad, "move": move}


def run(ctx: Context, device="cuda", fault=None) -> Record:
    """The cell's run on `device`, with `fault` (`faults.py`) planted in
    the program if given; `faults.CONTROL` puts the control's readings in
    the program's place."""
    with faults.fault(fault):
        return _run(ctx, device, fault == faults.CONTROL)


def _run(ctx: Context, device, control: bool) -> Record:
    trainee = _LDM(ctx, device)
    dev = trainee.trainer.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    out = run_training(ctx, trainee, sync, ctx.traffic["scan_block"],
                       trainee.batch)
    first, host = out["first"], out["first"]["host"]
    if control:
        first = reference_readings(ctx, host, "float8", dev)
    ref = reference_readings(ctx, host, "float32", dev)
    found = numbers(first, ref)
    limits = ctx.cell["checks"]
    work = {}
    if ctx.trace:
        work["step_flops"] = unet_step_flops(ctx.config, trainee.batch)
    return Record(
        host=out["host"], counters={"graph_capture_s": out["graph_capture_s"]},
        attempted=out["attempted"], failed=out["failed"],
        checks={k: Check(found[k][0], limits[k]) for k in limits},
        memory_peak_bytes=out["memory_peak_bytes"], chips=1,
        device_kind=out["device_kind"],
        trace=out["trace"], work=work,
        notes=found)
