"""VQ-GAN training past `disc_start` in scan mode: `VQGANTrainer` with
`step_mode="scan"`, every block of `scan_block` steps G+D (`scan_gd`),
one step's CUDA graph replayed per step, the images of a seeded host pool
fed through `data/prefetch.device_prefetch` as the trainer feeds its
loader's batches; each block's losses read one dispatch late.

Traffic parameters: scan_block, pool (images in the host pool),
trace_blocks (blocks in the traced sub-window).

The weights (VQ-VAE, PatchGAN, LPIPS's VGG16 and lin layers) come from
the seed, the same for the program and the reference. After the window
the reference (`reference/vqgan.py`, float32) takes the first three
steps on the same images, its quantizer following the codes the
program's quantizer chose in those steps (read by a forward hook that
set-up removes; it only keeps a reference to the codes, so the captured
step launches nothing more), and the numbers of `compare.py`, "codes"
among them (how far each code of the program is from nearest), are held
to the cell's limits. With the fault `faults.CONTROL` the reference in
float8, with codes of its own, takes the program's place.
"""

from __future__ import annotations

import statistics

import torch

from .. import compare, faults, inputs
from ..harness import Check, Context, Record, mark, seed_for
from ..reference.layers import Precision, float32_math
from ..reference.vqgan import VQGANReference, vqgan_spec, vqgan_step_flops
from ..training import CHECKED, Trainee, run_training
from ..weights import load_into, make_weights

__all__ = ["run", "reference_readings", "numbers"]


class _VQGAN(Trainee):
    def __init__(self, ctx: Context, device):
        from vqgan_tpu_torch.configs.vqgan_config import VQGANConfig
        from vqgan_tpu_torch.data.prefetch import device_prefetch, to_device
        from vqgan_tpu_torch.parallel.mesh import local_rows
        from vqgan_tpu_torch.training.vqgan_trainer import VQGANTrainer
        mark(ctx, "program imported")
        p = ctx.traffic
        cfg = VQGANConfig.from_dict({
            **ctx.config, "results_folder": str(ctx.scratch / "vqgan"),
            "seed": seed_for(ctx.seed, "program") % 2 ** 31})
        self.trainer = t = VQGANTrainer(cfg, device=device, step_mode="scan",
                                        scan_block=p["scan_block"])
        mark(ctx, "trainer built")
        weights = make_weights(vqgan_spec(ctx.config),
                               seed_for(ctx.seed, "weights"), t.device)
        for part, module in (("vqvae", t.vqvae), ("disc", t.disc),
                             ("lpips", t.lpips)):
            load_into(module, weights[part])
        del weights
        mark(ctx, "seeded weights loaded")
        t.state.step = cfg.disc_start  # every block is G+D
        self.batch = cfg.batch_size
        pool = inputs.image_pool(p["pool"], cfg.image_size, cfg.in_channels,
                                 seed_for(ctx.seed, "inputs"))
        feed = inputs.batches((pool,), cfg.batch_size,
                              seed_for(ctx.seed, "order"))
        rows = ((lambda x: local_rows(x, t.mesh)) if t.mesh is not None
                else (lambda x: x))
        self.batches = device_prefetch(
            feed, lambda b: to_device(rows(b[0]), t.device), depth=2)
        self.names = {
            "g": [f"vqvae.{n}" for n, q in t.vqvae.named_parameters()
                  if q.requires_grad],
            "d": [f"disc.{n}" for n, q in t.disc.named_parameters()
                  if q.requires_grad]}
        self._seen, self._read, self._steps = [], 0, 0
        self._hook = t.vqvae.quantizer.register_forward_hook(
            lambda module, args, out: self._seen.append(out[2]))

    def step_codes(self):
        """The codes of the step just run: a call of the quantizer's
        forward (step 1 eager, step 2 under capture) adds its index
        tensor; a replay (step 3) rewrites the captured one in place. The
        seen tensors are held until `close`, so that no later allocation
        takes the captured one's memory."""
        self._steps += 1
        new, self._read = len(self._seen) - self._read, len(self._seen)
        if self._steps == CHECKED:
            self._hook.remove()
        if not self._seen or new > 1:
            return None
        return self._seen[-1].detach().to("cpu", copy=True)

    def dispatch(self, drawn):
        t = self.trainer
        return t.dispatch_block(torch.stack([d[1] for d in drawn]),
                                t.state.step)

    def losses(self, logs):
        return {"g": logs["loss_total"], "d": logs["d_loss"]}

    def fed_grads(self):
        t, out = self.trainer, {}
        for key, opt in (("g", t.opt_g), ("d", t.opt_d)):
            b1 = opt.betas[0]
            out.update({n: m / (1.0 - b1)
                        for n, m in zip(self.names[key], opt.exp_avg)})
        return out

    def leaves(self):
        t = self.trainer
        out = {f"vqvae.{n}": q for n, q in t.vqvae.named_parameters()}
        out.update({f"disc.{n}": q for n, q in t.disc.named_parameters()})
        return out

    def graph_capture_s(self):
        return sum(st["capture_seconds"] or 0.0
                   for st in self.trainer.graph_stats())

    def close(self):
        self.batches.close()
        self.batches = self.trainer = self._seen = None


def reference_readings(ctx: Context, host_batches, precision: str,
                       device, codes=None) -> dict:
    """The reference's first `CHECKED` steps on the host batches the
    program ran, its quantizer following `codes` (one [B, h, w] tensor a
    step) where given: {"losses": {"g", "d"}, "grads", "leaves", "start",
    "codes", "code_shift"}."""
    with float32_math():
        weights = make_weights(vqgan_spec(ctx.config),
                               seed_for(ctx.seed, "weights"), device)
        start = {f"vqvae.{k}": v for k, v in weights["vqvae"].items()}
        start.update({f"disc.{k}": v for k, v in weights["disc"].items()})
        ref = VQGANReference(ctx.config, weights, Precision(precision))
        losses, grads = {"g": [], "d": []}, None
        taken, shifts = [], []
        for i, (images,) in enumerate(host_batches[:CHECKED]):
            out = ref.step(torch.as_tensor(images, device=device),
                           codes[i] if codes else None)
            taken.append(out["codes"])
            shifts.append(out["code_shift"])
            losses["g"].append(out["g_loss"])
            losses["d"].append(out["d_loss"])
            if grads is None:
                grads = {f"vqvae.{k}": v for k, v in out["g_grads"].items()}
                grads.update({f"disc.{k}": v
                              for k, v in out["d_grads"].items()})
        return {"losses": losses, "grads": grads, "leaves": ref.params(),
                "start": start, "codes": taken, "code_shift": shifts}


def numbers(program: dict, reference: dict) -> dict:
    """{"loss", "grad", "move", "grad_median", "loss1", "codes"} (see
    `compare.py`), each (value, where); "codes" is infinite where no
    codes were read of a step."""
    loss = max(compare.loss_gap(program["losses"][k], reference["losses"][k])
               for k in reference["losses"])
    grad = compare.leaf_gap(program["grads"], reference["grads"])
    start = reference["start"]
    quiet = compare.quiet_leaves(reference["grads"])
    moved_p = {k: program["leaves"][k].float() - start[k]
               for k in reference["leaves"] if k in program["leaves"]}
    moved_r = {k: v - start[k] for k, v in reference["leaves"].items()}
    move = compare.leaf_gap(moved_p, moved_r, quiet)
    median = statistics.median(compare.leaf_gaps(
        program["grads"], reference["grads"]).values())
    loss1 = max(compare.loss_gap(program["losses"][k][:1],
                                 reference["losses"][k][:1])
                for k in reference["losses"])
    shifts, read = reference["code_shift"], program.get("codes") or []
    codes = (float("inf"), "no codes read")
    if len(read) == CHECKED and all(c is not None for c in read):
        worst = max(range(CHECKED), key=lambda i: (shifts[i] != shifts[i],
                                                   shifts[i]))
        codes = (shifts[worst], f"step {worst + 1}")
    return {"loss": (loss, "steps 1-3"), "grad": grad, "move": move,
            "grad_median": (median, "the median leaf"),
            "loss1": (loss1, "step 1"), "codes": codes}


def run(ctx: Context, device="cuda", fault=None) -> Record:
    """The cell's run on `device`, with `fault` (`faults.py`) planted in
    the program if given; `faults.CONTROL` puts the control's readings in
    the program's place."""
    with faults.fault(fault):
        return _run(ctx, device, fault == faults.CONTROL)


def _run(ctx: Context, device, control: bool) -> Record:
    trainee = _VQGAN(ctx, device)
    dev = trainee.trainer.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    out = run_training(ctx, trainee, sync, ctx.traffic["scan_block"],
                       trainee.batch)
    first, host = out["first"], out["first"]["host"]
    if control:
        first = reference_readings(ctx, host, "float8", dev)
    ref = reference_readings(ctx, host, "float32", dev, first.get("codes"))
    found = numbers(first, ref)
    limits = ctx.cell["checks"]
    work = {}
    if ctx.trace:
        work["step_flops"] = vqgan_step_flops(ctx.config, trainee.batch)
    return Record(
        host=out["host"], counters={"graph_capture_s": out["graph_capture_s"]},
        attempted=out["attempted"], failed=out["failed"],
        checks={k: Check(found[k][0], limits[k]) for k in limits},
        memory_peak_bytes=out["memory_peak_bytes"], chips=1,
        device_kind=out["device_kind"],
        trace=out["trace"], work=work,
        notes=found)
