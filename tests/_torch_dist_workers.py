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


def tp_served(rank, world, outdir, partner, classes, init, steps):
    """A tensor-parallel artifact run on every rank, beside `partner` (an
    artifact of whole weights, or None) on the same noise: (the gathered
    images, the partner's, this rank's mesh coordinates, the split
    parameters of its step program as it holds them, `weight_bytes()`,
    and what graph=True raised over gloo)."""
    from vqgan_tpu_torch.serving import load_cfg_sampler
    from vqgan_tpu_torch.serving.export import _flat

    sampler = load_cfg_sampler(outdir, "cpu")
    args = (torch.from_numpy(classes),)
    noise = dict(init_noise=init, step_noise=steps)
    images = sampler(*args, **noise)
    want = (None if partner is None
            else load_cfg_sampler(partner, "cpu")(*args, **noise))
    held = {name: sampler._step.get_parameter(_flat(name)).detach().clone()
            for name in sampler.meta["param_specs"]["step"]}
    try:
        sampler(*args, **noise, graph=True)
        refused = None
    except ValueError as e:
        refused = str(e)
    coords = {a: sampler.mesh.coord(a) for a in sampler.mesh.axis_names}
    return images, want, coords, held, sampler.weight_bytes(), refused


def numpy_tree(x):
    """Copies as numpy (never views of a tensor's storage)."""
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [numpy_tree(v) for v in x]
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


def vqgan_modes(rank, world, cfg_kwargs, states, images, modes,
                revive=False):
    """For each step mode: the port's VQGANTrainer from the port state
    dicts `states` ({"vqvae", "disc", "lpips"}) on this rank's rows of
    each global batch of `images` [n, B, H, W, C]: "split" and "fused" one
    `dispatch_step` per batch, "scan" one `dispatch_block` of all n. With
    `revive`, a revival after the last step from the window of every
    step's usage. Returns {mode: {"logs": [{key: array}] per step,
    "vqvae", "disc" (state dicts), "counts" (G and D updates),
    "revived": (number, dead mask, codebook) or None}}."""
    from vqgan_tpu_torch.configs import VQGANConfig
    from vqgan_tpu_torch.parallel.mesh import local_rows
    from vqgan_tpu_torch.training.vqgan_trainer import VQGANTrainer

    out = {}
    for mode in modes:
        tr = VQGANTrainer(VQGANConfig(**cfg_kwargs), device="cpu",
                          step_mode=mode, scan_block=len(images))
        for name in ("vqvae", "disc", "lpips"):
            getattr(tr, name).load_state_dict(states[name])
        rows = [torch.from_numpy(x) for x in images]
        if tr.mesh is not None:
            rows = [local_rows(x, tr.mesh) for x in rows]
        if mode == "scan":
            stacked = tr.dispatch_block(torch.stack(rows), 0)
            logs = [{k: v[i] for k, v in stacked.items()}
                    for i in range(len(rows))]
        else:
            logs = [tr.dispatch_step(x, i) for i, x in enumerate(rows)]
        out[mode] = numpy_tree({
            "logs": logs, "vqvae": tr.vqvae.state_dict(),
            "disc": tr.disc.state_dict(),
            "counts": (tr.opt_g.state_dict()["count"],
                       tr.opt_d.state_dict()["count"])})
        out[mode]["revived"] = None
        if revive:
            if mode == "split":  # the captured modes sum inside the steps
                for log in logs:
                    tr._usage_accum += log["usage_counts"]
            window = tr._usage_accum.clone()
            dead = window < tr.config.revive_usage_threshold
            n = tr.revive(rows[-1], len(rows))
            out[mode]["revived"] = numpy_tree([
                n, dead, window,
                tr.vqvae.quantizer.embedding.weight.detach()])
    return out


def norm_layers(rank, world, x, weight, bias, grad_out):
    """`BatchNorm` in train mode and `ActNorm`'s initialisation on this
    rank's rows of `x` inside `global_batch` over every rank: BatchNorm's
    output rows, its running statistics after one pass, the gradients of
    sum(out * grad_out) for its weight and bias (averaged over the ranks)
    and for this rank's rows of x; ActNorm's bias and weight."""
    from vqgan_tpu_torch.models.discriminator import ActNorm, BatchNorm
    from vqgan_tpu_torch.parallel import make_mesh
    from vqgan_tpu_torch.parallel.mesh import (
        global_batch,
        local_rows,
        mean_over_data,
    )

    mesh = make_mesh(device="cpu") if world > 1 else None
    rows = torch.from_numpy(x)
    g_rows = torch.from_numpy(grad_out)
    if mesh is not None:
        rows, g_rows = local_rows(rows, mesh), local_rows(g_rows, mesh)
    bn = BatchNorm(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    rows = rows.clone().requires_grad_()
    with global_batch(mesh):
        out = bn(rows)
    # each rank's share of the global sum, as a loss over rows
    (out * g_rows).sum().backward()
    grads = mean_over_data([bn.weight.grad, bn.bias.grad], mesh)
    n = world if mesh is not None else 1
    act = ActNorm(x.shape[1])
    with global_batch(mesh):
        act(rows.detach(), init_actnorm=True)
    return numpy_tree({"out": out, "running_mean": bn.running_mean,
                       "running_var": bn.running_var,
                       "weight_grad": grads[0] * n, "bias_grad": grads[1] * n,
                       "x_grad": rows.grad, "act_bias": act.bias,
                       "act_weight": act.weight})


def ema_codebook(rank, world, codebook, size, total, z, idx):
    """`ema_codebook_update` on this rank's rows of z [N, D] and indices
    [N] inside `global_batch` over every rank."""
    from vqgan_tpu_torch.ops.vq import ema_codebook_update
    from vqgan_tpu_torch.parallel import make_mesh
    from vqgan_tpu_torch.parallel.mesh import global_batch, local_rows

    mesh = make_mesh(device="cpu")
    with global_batch(mesh):
        out = ema_codebook_update(
            torch.from_numpy(codebook), torch.from_numpy(size),
            torch.from_numpy(total), local_rows(torch.from_numpy(z), mesh),
            local_rows(torch.from_numpy(idx), mesh))
    return numpy_tree(list(out))


def kl_vae_steps(rank, world, cfg_kwargs, state, images, eps, kl_weight,
                 lr, seed):
    """The port's KL-VAE step (`make_kl_vae_train_step`) on this rank's
    rows of each global batch of `images` [n, B, H, W, C]: with the
    global posterior noise `eps` [n, B, h, w, c] injected where given,
    else drawn from a generator seeded with `seed`. Returns (the logs per
    step, the parameters)."""
    from vqgan_tpu_torch.models.autoencoder import AutoencoderConfig, KLVAE
    from vqgan_tpu_torch.parallel import make_mesh_for_batch
    from vqgan_tpu_torch.parallel.mesh import local_rows
    from vqgan_tpu_torch.training import (
        make_kl_vae_optimizer,
        make_kl_vae_train_step,
    )

    mesh = (make_mesh_for_batch(images.shape[1], device="cpu")
            if world > 1 else None)
    vae = KLVAE(AutoencoderConfig(**cfg_kwargs))
    vae.load_state_dict(state)
    opt = make_kl_vae_optimizer(vae.parameters(), lr, "constant",
                                len(images))
    step = make_kl_vae_train_step(vae, opt, kl_weight=kl_weight, mesh=mesh)
    generator = torch.Generator().manual_seed(seed)
    logs = []
    for i, x in enumerate(images):
        x = torch.from_numpy(x)
        if mesh is not None:
            x = local_rows(x, mesh)
        noise = (None if eps is None else
                 torch.from_numpy(eps[i]).permute(0, 3, 1, 2).contiguous())
        logs.append(step(x, generator=generator, noise=noise))
    return numpy_tree(logs), numpy_tree(dict(vae.named_parameters()))


def ddpm_steps(rank, world, unet_kwargs, diff_kwargs, state, images, draws,
               lr, seed, results):
    """The port's DDPM `Trainer.train_step` on this rank's rows of each
    global batch of `images` [n, B, H, W, C], with the global draws
    `draws[i]` ({"t", "noise", "self_cond_coin"}) where given, else drawn
    from the trainer's generator. Returns (the losses, the parameters,
    the EMA's)."""
    from vqgan_tpu_torch.diffusion import GaussianDiffusion
    from vqgan_tpu_torch.models import Unet
    from vqgan_tpu_torch.parallel.mesh import local_rows
    from vqgan_tpu_torch.training.ddpm_trainer import Trainer

    net = Unet(**unet_kwargs)
    net.load_state_dict(state)
    diffusion = GaussianDiffusion(net, **diff_kwargs, device="cpu")
    tr = Trainer(diffusion, net, train_batch_size=images.shape[1],
                 train_lr=lr, results_folder=results, seed=seed)
    losses = []
    for i, x in enumerate(images):
        x = torch.from_numpy(x)
        if tr.mesh is not None:
            x = local_rows(x, tr.mesh)
        kwargs = {} if draws is None else {
            k: torch.as_tensor(v) for k, v in draws[i].items()}
        losses.append(float(tr.train_step(x, **kwargs)))
    return (losses, numpy_tree(dict(net.named_parameters())),
            numpy_tree(dict(tr.ema_model.named_parameters())))


def ddpm_fid_milestone(rank, world, unet_kwargs, diff_kwargs, state,
                       real, n_fid, batch, results):
    """A DDPM `Trainer` milestone with the FID, its evaluator over the
    first 4 values of each image as its features: this rank's share of
    `real` [n, H, W, C] (its `rank_batches`) for the real statistics, then
    `save_and_sample(1)`.
    Returns (the FID, the real (mu, cov), the features of this rank's
    generated images, the checkpoints this rank sees)."""
    from vqgan_tpu_torch.checkpoint import CheckpointManager
    from vqgan_tpu_torch.diffusion import GaussianDiffusion
    from vqgan_tpu_torch.eval.fid import FIDEvaluation, rank_batches
    from vqgan_tpu_torch.models import Unet
    from vqgan_tpu_torch.training.ddpm_trainer import Trainer

    net = Unet(**unet_kwargs)
    net.load_state_dict(state)
    diffusion = GaussianDiffusion(net, **diff_kwargs, device="cpu")
    made = []

    def features(images):
        out = torch.as_tensor(images).reshape(len(images), -1)[:, :4]
        made.append(out.numpy())
        return out

    ev = FIDEvaluation(features, batch_size=batch, num_fid_samples=n_fid,
                       dim=4)
    real_mu_cov = ev.load_or_precalc_real_stats(
        real[a:b] for a, b in rank_batches(len(real), batch))
    made.clear()  # from here on, the generated images' features
    tr = Trainer(diffusion, net, train_batch_size=4, results_folder=results,
                 calculate_fid=True, fid_evaluator=ev, num_samples=4)
    tr.save_and_sample(1)
    return (tr.last_fid, real_mu_cov, made,
            CheckpointManager(results, prefix="model").all_milestones())


def immiscible_gathers(rank, world, unet_kwargs, diff_kwargs, state,
                       images, t):
    """`p_losses` with immiscible noise inside `global_batch` on this
    rank's rows of `images`, the noise drawn and then given (this rank's
    rows of a draw): the all-gathers each call makes."""
    from vqgan_tpu_torch.diffusion import GaussianDiffusion
    from vqgan_tpu_torch.models import Unet
    from vqgan_tpu_torch.parallel import comm
    from vqgan_tpu_torch.parallel.mesh import (global_batch, local_rows,
                                               make_mesh_for_batch)

    net = Unet(**unet_kwargs)
    net.load_state_dict(state)
    diffusion = GaussianDiffusion(net, **diff_kwargs, device="cpu")
    mesh = make_mesh_for_batch(len(images), device="cpu")
    x = local_rows(torch.from_numpy(images), mesh)
    t = local_rows(torch.as_tensor(t), mesh)
    gathers, gather = [], comm.all_gather_cat

    def counted(*args, **kwargs):
        gathers[-1] += 1
        return gather(*args, **kwargs)

    comm.all_gather_cat = counted
    try:
        with global_batch(mesh):
            for noise in (None, torch.randn(x.shape)):
                gathers.append(0)
                diffusion.p_losses(x, t, noise=noise,
                                   generator=torch.Generator().manual_seed(0))
    finally:
        comm.all_gather_cat = gather
    return gathers


def ldm_step_and_scan(rank, world, cfg_kwargs, modes, batches, min_size):
    """For each --param_sharding mode, the port's LDM trainer in step mode
    and in scan mode (one block of every batch) on this rank's rows of the
    global batches (draws from the trainer's generator): the logs per step
    and the gathered parameters and EMA, per step mode."""
    from vqgan_tpu_torch.configs.ldm_config import LDMConfig
    from vqgan_tpu_torch.parallel.mesh import local_rows
    from vqgan_tpu_torch.training.ldm_trainer import LatentDiffusionTrainer

    out = {}
    for mode in modes:
        for step_mode in ("step", "scan"):
            tr = LatentDiffusionTrainer(
                LDMConfig(**cfg_kwargs), device="cpu", param_sharding=mode,
                fsdp_min_size=min_size, step_mode=step_mode)
            rows = [[local_rows(torch.from_numpy(a), tr.mesh)
                     for a in batch] for batch in batches]
            if step_mode == "scan":
                stacked = tr.dispatch_block(
                    torch.stack([r[0] for r in rows]),
                    torch.stack([r[1] for r in rows]).long())
                logs = [{k: float(v[i]) for k, v in stacked.items()}
                        for i in range(len(rows))]
            else:
                logs = [{k: float(v) for k, v in tr.train_step(
                    tr.state, latents, labels.long(),
                    generator=tr.generator).items()}
                    for latents, labels in rows]
            out[(mode, step_mode)] = {
                "logs": logs, "model": tr.placed.gathered("model"),
                "ema": tr.placed.gathered("ema"), "step": tr.state.step}
    return out


def capture_refusal(rank, world):
    """Inside what the collectives take for a CUDA graph capture, a gloo
    collective raises: the message of each of all_reduce_, all_gather_cat
    and broadcast_."""
    from vqgan_tpu_torch.parallel import comm

    comm.capturing = lambda: True
    messages = []
    for fn in (lambda t: comm.all_reduce_(t),
               lambda t: comm.all_gather_cat(t, 0),
               lambda t: comm.broadcast_(t, 0)):
        try:
            fn(torch.ones(3))
            messages.append(None)
        except RuntimeError as e:
            messages.append(str(e))
    return messages


def cli_run(rank, world, module, argv, small=None):
    """`vqgan_tpu_torch.<module>.main(argv)` on this rank (the process
    group already up, as torchrun's would be), or for train_kl_vae with
    `small` (AutoencoderConfig fields) its `train`. Returns (the losses,
    the trained parameters)."""
    import importlib

    cli = importlib.import_module(f"vqgan_tpu_torch.{module}")
    if small is not None:
        from vqgan_tpu_torch.models.autoencoder import AutoencoderConfig

        result = cli.train(cli.parse_args(argv), AutoencoderConfig(**small))
        model = result["vae"]
    else:
        result = cli.main(argv)
        trainer = result["trainer"]
        model = getattr(trainer, "vqvae", None) or trainer.model
    return (list(map(float, result["losses"])),
            numpy_tree(dict(model.named_parameters())))


def ldm_scan_captured(rank, world, cfg_kwargs, batches, mode):
    """On the card: the LDM trainer's scan mode under `mode` on this
    rank's rows, captured (graph) and eager (graph=False), one block of
    every batch each, cuDNN deterministic. Returns {graph: (logs, the
    gathered parameters)} and the graphs' kernel launches per replay."""
    from vqgan_tpu_torch.configs.ldm_config import LDMConfig
    from vqgan_tpu_torch.parallel.mesh import local_rows
    from vqgan_tpu_torch.training.ldm_trainer import LatentDiffusionTrainer

    torch.backends.cudnn.deterministic = True
    out = {}
    for graph in (True, False):
        tr = LatentDiffusionTrainer(LDMConfig(**cfg_kwargs), device="cuda",
                                    param_sharding=mode, step_mode="scan",
                                    graph=graph)
        rows = [[local_rows(torch.from_numpy(a), tr.mesh).cuda()
                 for a in batch] for batch in batches]
        logs = []
        for _ in range(2):  # the warm-up call, then the captured replays
            stacked = tr.dispatch_block(
                torch.stack([r[0] for r in rows]),
                torch.stack([r[1] for r in rows]).long())
            logs.append(numpy_tree(stacked))
        out[graph] = (logs, numpy_tree(tr.placed.gathered("model")),
                      tr.graph_stats())
    return out


def gloo_in_capture(rank, world):
    """On the card, in a gloo group: an all-reduce of a CUDA tensor inside
    a real CUDA graph capture. Returns the error's message."""
    from vqgan_tpu_torch.parallel import comm

    x = torch.ones(4, device="cuda")
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    try:
        with torch.cuda.stream(side), torch.cuda.graph(graph):
            comm.all_reduce_(x)
    except RuntimeError as e:
        return str(e)
    return None


class _GatheredBytes:
    """The bytes of whole parameters alive while a sharded step runs: every
    tensor `fsdp.gather_tensor` makes, and every cast of one (`Tensor.to`),
    tracked by their storages; `peak` is the most alive at once, sampled
    as each one is made."""

    def __init__(self):
        from torch.multiprocessing.reductions import StorageWeakRef

        self.ref = StorageWeakRef
        self.live = {}
        self.peak = 0
        self.on = False

    def holds(self, t):
        entry = self.live.get(t.untyped_storage()._cdata)
        return entry is not None and not entry[0].expired()

    def alive(self):
        self.live = {k: v for k, v in self.live.items()
                     if not v[0].expired()}
        return sum(v[1] for v in self.live.values())

    def add(self, t):
        if not self.on:
            return
        s = t.untyped_storage()
        self.live[s._cdata] = (self.ref(s), s.nbytes())
        self.peak = max(self.peak, self.alive())


def _layer_run(rank, world, cfg_kwargs, mode, min_size, batch, weights=None,
               draws=None, trainer_kwargs=None, steps=1, step_mode="step",
               save=False):
    """One sharded LDM trainer under `mode`, `steps` steps on this rank's
    rows of `batch` (the global draws `draws`, if given), instrumented:
    the peak bytes of gathered parameters alive in the forward and the
    backward, those alive between the two, each collective's kind and
    size, what the model holds after the step, and the logs and gathered
    state; with `save`, milestone 1 written after the steps. Returns
    (that, a weak reference to the model)."""
    import contextlib
    import weakref

    from vqgan_tpu_torch.configs.ldm_config import LDMConfig
    from vqgan_tpu_torch.parallel import comm, fsdp
    from vqgan_tpu_torch.parallel.mesh import local_rows
    from vqgan_tpu_torch.training.ldm_trainer import LatentDiffusionTrainer

    tr = LatentDiffusionTrainer(LDMConfig(**cfg_kwargs), device="cpu",
                                param_sharding=mode, fsdp_min_size=min_size,
                                step_mode=step_mode,
                                **(trainer_kwargs or {}))
    placed = tr.placed
    if weights is not None:
        fresh = placed.state_dict()
        placed.load_state_dict({"step": 0, "model": weights,
                                "ema": weights,
                                "optimizer": fresh["optimizer"]})
    tracked = _GatheredBytes()
    calls = []
    originals = (fsdp.gather_tensor, comm.all_reduce_, comm.reduce_scatter,
                 torch.Tensor.to, placed.gradients, placed.holding_pieces)
    between = []  # bytes alive after each forward, before its backward

    def gather(*a, **k):
        out = originals[0](*a, **k)
        tracked.add(out)
        return out

    def all_reduce(t, *a, **k):
        calls.append(("all_reduce", t.numel()))
        return originals[1](t, *a, **k)

    def reduce_scatter(t, dim, *a, **k):
        calls.append(("reduce_scatter", tuple(t.shape)))
        return originals[2](t, dim, *a, **k)

    def to(self, *a, **k):
        out = originals[3](self, *a, **k)
        if out is not self and tracked.on and tracked.holds(self):
            tracked.add(out)
        return out

    def gradients():
        tracked.on = False
        return originals[4]()

    @contextlib.contextmanager
    def holding():
        with originals[5]():
            yield
        between.append(tracked.alive())

    fsdp.gather_tensor, comm.all_reduce_ = gather, all_reduce
    comm.reduce_scatter, torch.Tensor.to = reduce_scatter, to
    placed.gradients, placed.holding_pieces = gradients, holding
    latents, labels = (local_rows(torch.from_numpy(a), tr.mesh)
                       for a in batch)
    given = {} if draws is None else dict(
        t=torch.from_numpy(draws[0]).long(), noise=torch.from_numpy(draws[1]))
    logs = []
    try:
        for _ in range(steps):
            tracked.on = True
            calls.append(("step",))
            if step_mode == "scan":
                block = tr.dispatch_block(latents[None], labels[None].long())
                logs.append({k: float(v[0]) for k, v in block.items()})
            else:
                log = tr.train_step(tr.state, latents, labels.long(),
                                    generator=tr.generator, **given)
                logs.append({k: float(v) for k, v in log.items()})
    finally:
        (fsdp.gather_tensor, comm.all_reduce_, comm.reduce_scatter,
         torch.Tensor.to) = originals[:4]
        del placed.gradients, placed.holding_pieces
    if save:
        tr.save_and_sample(1)
    compute = LDMConfig(**cfg_kwargs).compute_dtype
    ratio = 1.0 if compute == "float32" else 1.5  # the cast beside the fp32
    names = {m: name for name, m in tr.model.named_modules()}
    owned = {names[module]: ratio * sum(4 * _whole_numel(placed, n)
                                        for _, n in attrs)
             for module, attrs in placed._owned.items()}
    return {
        "mesh": dict(tr.mesh.shape), "logs": logs, "peak": tracked.peak,
        "between": between,
        "owned": owned, "calls": calls,
        "whole_numel": {n: _whole_numel(placed, n) for n in placed.trainable},
        "specs": {n: (placed.param_specs[n], placed.opt_specs[n])
                  for n in placed.trainable},
        "held": {n: p.numel() for n, p in placed.params.items()},
        "ema_held": {n: p.numel() for n, p in placed.ema_params.items()},
        "pieces": {n: t.numel() for n, t in placed.opt_tensors.items()},
        "all_parameters": all(isinstance(p, torch.nn.Parameter)
                              for m in tr.model.modules()
                              for p in m._parameters.values()
                              if p is not None),
        "model": placed.gathered("model"), "ema": placed.gathered("ema")
    }, weakref.ref(tr.model)


def _whole_numel(placed, name):
    n = placed.opt_tensors[name].numel()
    return n * placed._ways(placed.opt_specs[name])


def layer_by_layer(rank, world, runs, scatter_input):
    """{key: `_layer_run(**kwargs)`} for each (key, kwargs) in `runs`, and
    under its "freed" whether the trainer's model was freed after it;
    under "scatter", per dim 0 and 1: `comm.reduce_scatter` of this rank's
    multiple of `scatter_input` beside `all_reduce_` and this rank's slice;
    under "refused", the message of a reduce-scatter inside what the
    collectives take for a CUDA graph capture."""
    from vqgan_tpu_torch.parallel import comm

    import gc

    out = {}
    for key, kwargs in runs:
        out[key], model = _layer_run(rank, world, **kwargs)
        gc.collect()
        out[key]["freed"] = model() is None
    x = torch.from_numpy(scatter_input) * (rank + 1)
    out["scatter"] = {
        dim: (comm.reduce_scatter(x, dim),
              comm.all_reduce_(x.clone()).chunk(world, dim)[rank])
        for dim in (0, 1)}
    capturing, comm.capturing = comm.capturing, lambda: True
    try:
        comm.reduce_scatter(x, 0)
        out["refused"] = None
    except RuntimeError as e:
        out["refused"] = str(e)
    finally:
        comm.capturing = capturing
    return out


def resumed_steps(rank, world, cfg_kwargs, mode, min_size, batches, draws):
    """The port's LDM trainer under `mode` (FSDP cutoff `min_size`)
    resumed from the milestone in its results folder (a JAX train state),
    then one step per batch of `batches` (the global batch, this rank
    taking its rows) with the global draws `draws` ((t, noise) per step).
    Returns {"start", "step", "split" (how many parameters are split),
    "logs", "model", "ema"} (the whole tensors after the steps)."""
    from vqgan_tpu_torch.configs.ldm_config import LDMConfig
    from vqgan_tpu_torch.parallel.mesh import local_rows
    from vqgan_tpu_torch.training.ldm_trainer import LatentDiffusionTrainer

    tr = LatentDiffusionTrainer(LDMConfig.from_dict(cfg_kwargs),
                                device="cpu", param_sharding=mode,
                                fsdp_min_size=min_size)
    start = tr.load()
    logs = []
    for (latents, labels), (t, noise) in zip(batches, draws):
        log = tr.train_step(
            tr.state, local_rows(torch.from_numpy(latents), tr.mesh),
            local_rows(torch.from_numpy(labels), tr.mesh).long(),
            generator=tr.generator, t=torch.from_numpy(t).long(),
            noise=torch.from_numpy(noise))
        logs.append({k: float(v) for k, v in log.items()})
    after = tr.placed.state_dict()
    return {"start": start, "step": tr.state.step,
            "split": len(tr.placed.split_params), "logs": logs,
            "model": after["model"], "ema": after["ema"]}
