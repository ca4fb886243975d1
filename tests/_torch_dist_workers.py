"""Rank functions for the port's multi-process tests.

`vqgan_tpu_torch.parallel.launch.spawn` runs each of these on N gloo ranks
of the CPU; they import torch and the port only (no JAX), take numpy or
torch inputs made by the test, and return what the test compares.
"""

import numpy as np
import torch

MODES = ("replicated", "zero1", "fsdp", "tp", "fsdp_tp")


def trainer_modes(rank, world, cfg_kwargs, weights, batch, draws,
                  min_size, modes=MODES):
    """For each --param_sharding mode: the port's LDM trainer from
    `weights` (a port state dict), one step on this rank's rows of `batch`
    with the global draws `draws`. Returns {mode: {"mesh", "log", "model",
    "ema", "placed_before" (the gathered state before the step)}}."""
    from vqgan_tpu_torch.configs.ldm_config import LDMConfig
    from vqgan_tpu_torch.parallel.mesh import local_rows
    from vqgan_tpu_torch.training.ldm_trainer import LatentDiffusionTrainer

    out = {}
    for mode in modes:
        cfg = LDMConfig(**cfg_kwargs)
        tr = LatentDiffusionTrainer(cfg, device="cpu", param_sharding=mode,
                                    fsdp_min_size=min_size)
        fresh = tr.placed.state_dict()
        tr.placed.load_state_dict({"step": 0, "model": weights,
                                   "ema": weights,
                                   "optimizer": fresh["optimizer"]})
        before = {k: v.clone()
                  for k, v in tr.placed.state_dict()["model"].items()}
        latents, labels = (torch.from_numpy(a) for a in batch)
        log = tr.train_step(
            tr.state, local_rows(latents, tr.mesh),
            local_rows(labels, tr.mesh).long(), generator=tr.generator,
            t=torch.from_numpy(draws[0]).long(),
            noise=torch.from_numpy(draws[1]))
        after = tr.placed.state_dict()
        out[mode] = {"mesh": dict(tr.mesh.shape),
                     "log": {k: float(v) for k, v in log.items()},
                     "model": after["model"], "ema": after["ema"],
                     "before": before,
                     "pieces": {n: tuple(t.shape) for n, t in
                                tr.placed.opt_tensors.items()}}
    return out


def batch_rows(rank, world, global_batch):
    """This rank's rows of a global batch on a (2, world / 2) mesh, and
    `make_global_array` of them."""
    from vqgan_tpu_torch.parallel import make_global_array, make_mesh
    from vqgan_tpu_torch.parallel.mesh import shard_batch

    mesh = make_mesh(data=2, model=world // 2, device="cpu")
    rows = shard_batch(torch.from_numpy(global_batch), mesh)
    placed = make_global_array(rows.numpy(), mesh)
    return rows, placed, (mesh.coord("data"), mesh.coord("model"))


def ring(rank, world, q, k, v, do, dtypes):
    """dtype -> (this rank's output block, its blocks' gradients) of
    `ring_attention` over a "seq" mesh of every rank."""
    from vqgan_tpu_torch.ops.ring_attention import ring_attention
    from vqgan_tpu_torch.parallel import named_mesh

    mesh = named_mesh({"seq": world}, "cpu")
    i = mesh.coord("seq")
    out = {}
    for dtype in dtypes:
        dt = getattr(torch, dtype)
        ql, kl, vl = (torch.from_numpy(t).chunk(world, 1)[i].to(dt)
                      .requires_grad_() for t in (q, k, v))
        o = ring_attention(ql, kl, vl, mesh)
        o.backward(torch.from_numpy(do).chunk(world, 1)[i].to(dt))
        out[dtype] = tuple(t.detach().float() for t in
                           (o, ql.grad, kl.grad, vl.grad))
    return out


def dit_pipeline(rank, world, dit_kwargs, state, inputs, stages):
    """`dit_pipeline_forward` over a ("data", "stage") mesh of every rank:
    (this rank's output rows, the gradient of sum(out^2) for each
    parameter, the stage index)."""
    from vqgan_tpu_torch.models.dit import DiT, dit_pipeline_forward
    from vqgan_tpu_torch.parallel import make_pipeline_mesh
    from vqgan_tpu_torch.parallel.mesh import local_rows

    mesh = make_pipeline_mesh(stages, data=world // stages, device="cpu")
    dit = DiT(**dit_kwargs)
    dit.load_state_dict(state)
    x, t, c, mask = (local_rows(torch.from_numpy(a), mesh) for a in inputs)
    out = dit_pipeline_forward(dit, x, t.long(), c.long(), mesh,
                               num_microbatches=2, cond_drop_mask=mask)
    (out ** 2).sum().backward()
    grads = {n: p.grad.clone() for n, p in dit.named_parameters()
             if p.grad is not None}
    return out.detach(), grads, mesh.coord("stage")


def served(rank, world, outdir, classes, init, steps):
    """A data-parallel artifact run on every rank: the gathered images."""
    from vqgan_tpu_torch.serving import load_cfg_sampler

    sampler = load_cfg_sampler(outdir, "cpu")
    return sampler(torch.from_numpy(classes), init_noise=init,
                   step_noise=steps)


def numpy_tree(x):
    """Copies as numpy (never views of a tensor's storage)."""
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    if torch.is_tensor(x):
        return x.detach().cpu().numpy().copy()
    return np.array(x, copy=True)


def variant_steps(rank, world, cfg_kwargs, mode, batches, min_size):
    """Two steps of the port's LDM trainer under `mode` on this rank's
    rows of each batch (draws from the trainer's generator): the logs and
    the gathered parameters."""
    from vqgan_tpu_torch.configs.ldm_config import LDMConfig
    from vqgan_tpu_torch.parallel.mesh import local_rows
    from vqgan_tpu_torch.training.ldm_trainer import LatentDiffusionTrainer

    tr = LatentDiffusionTrainer(LDMConfig(**cfg_kwargs), device="cpu",
                                param_sharding=mode, fsdp_min_size=min_size)
    logs = []
    for latents, labels in batches:
        rows = [local_rows(torch.from_numpy(a), tr.mesh)
                for a in (latents, labels)]
        log = tr.train_step(tr.state, rows[0], rows[1].long(),
                            generator=tr.generator)
        logs.append({k: float(v) for k, v in log.items()})
    return logs, tr.placed.gathered("model")


def train_run(rank, world, cfg_kwargs, split, mode, steps):
    """`LatentDiffusionTrainer.train` over a latent split on this rank's
    rows of each global batch: the losses, the loader and the gathered
    parameters."""
    from vqgan_tpu_torch.configs.ldm_config import LDMConfig
    from vqgan_tpu_torch.training.ldm_trainer import LatentDiffusionTrainer

    tr = LatentDiffusionTrainer(LDMConfig(**cfg_kwargs), split_path=split,
                                device="cpu", param_sharding=mode)
    out = tr.train(num_steps=steps, log_every=0)
    params = (tr.placed.gathered("model") if tr.placed is not None
              else {k: v.detach() for k, v in tr.model.named_parameters()})
    return out["losses"], out["loader"], params
