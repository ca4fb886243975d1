"""Resuming the port's trainers from the JAX package's train states
(vqgan_tpu_torch/checkpoint/train_state.py, behind
`CheckpointManager.restore` and each trainer's `load`).

Each state is saved by the JAX package's `CheckpointManager` as its
trainers save them; the port resumes it and takes the next two steps
beside JAX's, with JAX's draws replayed (t and the noise, from its PRNG
key folded by the step; class dropout off). Held by
test_torch_port_parallel.py's rule: losses and gradient norms at rtol
1e-4, parameters and EMA at atol 0.05 x lr.

- Conversion alone: every Adam moment of the committed fixture's `ldm` and
  `vqgan` milestones (tests/fixtures/jax_orbax/), as the port maps it onto
  its optimizers, equals orbax's read of it through the converter, bit for
  bit; the counts too.
- LDM: the JAX `LatentDiffusionTrainer`'s state and jitted step, built
  from the parts its constructor builds them from (`JaxLDM`; seeded
  initial weights), at a tiny U-Net with AdamW, warmup over 100 updates,
  MultiSteps k = 2 and the EMA every step, saved after 105 micro-steps:
  mid-accumulation, inside the warmup, the EMA past its warm copy. The
  port resumes it eagerly, in scan mode over the `CapturableOptimizer`,
  and under `--param_sharding fsdp` on 2 gloo ranks.
- The committed fixture through phase 8's resume (`chip_smoke.
  check_jax_resume`) on the CPU: the LDM in both step modes and the
  VQ-GAN against the JAX trainers' steps in resume_expected.npz.
- DiT: the same for `model_type` "dit", resumed by the port's trainer
  (steps against JAX) and by `train_latent_cfg --model_type dit --resume
  -1`, whose `.pt` milestone the port resumes again.
- `train_stage1_diffusers --resume_from_checkpoint latest` on a JAX
  milestone of its U-Net.
- Refusals, each naming its cause: an AdamW optimizer against an adam
  tree, a leaf removed from `mu`, a schedule count that disagrees with
  Adam's, MultiSteps against a plain chain, and a restore without a state.

The VQ-GAN and DDPM cases and their CLIs are in
test_torch_port_resume_jax_gan_ddpm.py.
"""

import dataclasses
import json
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import _torch_dist_workers as workers
from vqgan_tpu.checkpoint import CheckpointManager as JCheckpointManager
from vqgan_tpu.configs import LDMConfig as JLDMConfig
from vqgan_tpu.training.ldm_step import LDMTrainState as JLDMState
from vqgan_tpu.training.ldm_step import make_ldm_optimizer as j_ldm_optimizer
from vqgan_tpu.training.ldm_step import (
    make_ldm_train_step as j_ldm_train_step,
)
from vqgan_tpu.training.ldm_trainer import build_cfg_unet_diffusion as j_build
from vqgan_tpu_torch import train_latent_cfg, train_stage1_diffusers
from vqgan_tpu_torch.checkpoint import (
    CheckpointManager,
    cfg_unet_state_from_jax,
    dit_state_from_jax,
    optimizer_state_from_jax,
    patchgan_state_from_jax,
    train_state_from_jax,
    vqvae_state_from_jax,
)
from vqgan_tpu_torch.checkpoint.orbax import read_orbax
from vqgan_tpu_torch.configs import LDMConfig, VQGANConfig
from vqgan_tpu_torch.data import LatentCache, save_split
from vqgan_tpu_torch.parallel.launch import spawn
from vqgan_tpu_torch.training.ldm_step import make_ldm_optimizer
from vqgan_tpu_torch.training.ldm_trainer import LatentDiffusionTrainer
from vqgan_tpu_torch.training.vqgan_trainer import VQGANTrainer

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "jax_orbax"
RTOL = 1e-4
MOVE = 0.05  # x lr
LR = 1e-3
B = 8
# the LDM: AdamW, warmup over 100 updates (the milestone's 52 inside it),
# MultiSteps k = 2 (105 micro-steps: one gradient accumulated), the EMA
# every step (past step 100 it decays instead of copying)
LDM_TINY = dict(dim=8, dim_mults=(1,), attn_heads=2, attn_dim_head=8,
                num_users=3, latent_size=8, image_size=64, timesteps=20,
                sampling_timesteps=3, train_batch_size=B, seed=5,
                compute_dtype="float32", cond_drop_prob=0.0, train_lr=LR,
                save_and_sample_every=1000, weight_decay=1e-2,
                use_lr_warmup=True, warmup_steps=100,
                gradient_accumulate_every=2, ema_update_every=1)
LDM_BEFORE = 105
DIT_TINY = dict(model_type="dit", dim=8, dit_depth=2, dit_patch_size=2,
                attn_heads=2, attn_dim_head=16, num_users=3, latent_size=4,
                image_size=32, timesteps=20, sampling_timesteps=3,
                train_batch_size=4, seed=3, compute_dtype="float32",
                cond_drop_prob=0.0, train_lr=LR, save_and_sample_every=2)
# test_torch_port_vqgan_train's rule for the VQ-GAN's moves: Adam's first
# updates are sign-like, so a conv bias under GroupNorm (a gradient of 0 in
# exact arithmetic, rounding noise in practice) moves about lr one way on
# one side and the other way on the other. The moves agree within 0.05 x
# lr in all but 1% of the elements, and differ by at most 5% in norm.
VQ_MOVE_MISS = 0.01
VQ_MOVE_NORM = 0.05
SPAWN_TIMEOUT = 180


def fill(shapes, seed):
    """Seeded values in the shapes of a jax.eval_shape tree: kernels
    scaled by their fan-in, norms near 1, biases small."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, sds in flatten_dict(shapes).items():
        n = rng.standard_normal(sds.shape).astype(np.float32)
        if path[-1] == "kernel":
            n /= np.sqrt(np.prod(sds.shape[:-1]))
        elif path[-1] in ("scale", "g"):
            n = 1.0 + 0.05 * n
        elif path[-1] in ("bias", "mean"):
            n *= 0.05
        elif path[-1] == "var":
            n = np.ones_like(n)
        out[path] = n
    return unflatten_dict(out)


def optax_state(tx, params, count, seed):
    """An optax state of `tx` over `params` in the form `tx.init` gives
    (its tree read by `jax.eval_shape`), every count `count` and every
    float leaf (moments, accumulators) a seeded value >= 0."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        if jnp.issubdtype(s.dtype, jnp.integer):
            return np.asarray(count, s.dtype)
        return (1e-3 * np.abs(rng.standard_normal(s.shape))).astype(s.dtype)

    return jax.tree.map(leaf, jax.eval_shape(tx.init, params))


def jax_draws(base_key, step, shape, timesteps):
    """(t, noise) of the JAX step at `step`: `fold_in(key, step)`, then
    GaussianDiffusion.loss's split and p_losses' split."""
    k_t, k_p = jax.random.split(jax.random.fold_in(base_key, step))
    t = jax.random.randint(k_t, (shape[0],), 0, timesteps)
    noise = jax.random.normal(jax.random.split(k_p, 3)[0], shape,
                              jnp.float32)
    return np.array(t), np.array(noise)  # writable, for torch.from_numpy


def assert_moves(got, want, before, lr, label):
    """Parameters after the steps (port names) within MOVE x lr of JAX's;
    `before` (JAX's, converted; None where the steps leave them, as the
    DDPM's EMA before step 100) shows that the steps moved them."""
    moved = 0.0
    for name, value in want.items():
        torch.testing.assert_close(got[name].float(), value, rtol=0,
                                   atol=MOVE * lr,
                                   msg=lambda m: f"{label} {name}: {m}")
        if before is not None:
            moved = max(moved, float((value - before[name]).abs().max()))
    assert before is None or moved > 0.1 * lr, \
        f"{label}: the steps moved nothing"


def assert_logs(got, want, label):
    for key, ref in want.items():
        np.testing.assert_allclose(got[key], ref, rtol=RTOL, atol=1e-7,
                                   err_msg=f"{label} {key}")


# --- latent data for the LDM CLIs -----------------------------------------


def write_latents(root: Path, size: int, n_per_user=4) -> Path:
    rng = np.random.default_rng(0)
    cache = LatentCache(root / "cache")
    split = {"metadata": {}, "users": {}}
    for user in (1, 2, 3):
        names = [f"frame_{i:03d}.png" for i in range(n_per_user)]
        split["users"][f"ID_{user}"] = {"train_images": names,
                                        "test_images": []}
        for name in names:
            cache.save(user - 1, name, rng.standard_normal(
                (size, size, 4)).astype(np.float32))
    save_split(split, root / "split.json")
    return root / "split.json"


def port_config(cls, root: Path, prefix: str, milestone: int = 1):
    """The port's config from the JAX milestone's saved one."""
    raw = json.loads((root / f"{prefix}-{milestone}.config.json").read_text())
    return cls.from_dict({**raw, "results_folder": str(root)})


# --- conversion alone -------------------------------------------------------


@pytest.mark.parametrize("name", ["ldm", "vqgan"])
def test_every_moment_of_the_committed_fixture_converts_bit_for_bit(
        name, tmp_path):
    prefix = "model" if name == "ldm" else "vqgan"
    root = tmp_path / name  # the trainers write their logs beside it
    shutil.copytree(FIXTURE / name, root)
    path = root / f"{prefix}-1"
    ref = ocp.StandardCheckpointer().restore(path)
    if name == "ldm":
        trainer = LatentDiffusionTrainer(port_config(LDMConfig, root, prefix),
                                         device="cpu")
        got = train_state_from_jax(read_orbax(path), trainer.state)
        parts = [(got["optimizer"], ref["opt_state"][1][0],
                  cfg_unet_state_from_jax, trainer.model)]
    else:
        trainer = VQGANTrainer(port_config(VQGANConfig, root, prefix),
                               device="cpu")
        got = train_state_from_jax(read_orbax(path), trainer.state)
        parts = [(got["opt_g"], ref["opt_g"][1][0], vqvae_state_from_jax,
                  trainer.vqvae),
                 (got["opt_d"], ref["opt_d"][1][0], patchgan_state_from_jax,
                  trainer.disc)]
    assert got.keys() == trainer.state.state_dict().keys()
    n = 0
    for opt, adam, convert, model in parts:
        names = [k for k, p in model.named_parameters() if p.requires_grad]
        for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            want = convert(adam[field])
            assert set(want) == set(names)
            for i, k in enumerate(names):
                assert torch.equal(opt["inner"]["state"][i][key], want[k]), k
                n += 1
        assert opt["count"] == int(adam["count"])
        assert all(int(s["step"]) == opt["count"]
                   for s in opt["inner"]["state"].values())
    assert n == {"ldm": 224, "vqgan": 322}[name]  # 112 / 151 + 10 moments


# --- LDM: eager, scan, fsdp -------------------------------------------------


class JaxLDM:
    """The JAX `LatentDiffusionTrainer`'s state and step for `cfg`, built
    as its constructor builds them (`build_cfg_unet_diffusion`,
    `make_ldm_optimizer`, `make_ldm_train_step` with its step kwargs, the
    key PRNGKey(seed + 1)), the initial weights seeded numpy values (the
    trainer's un-jitted init compiles for 20 s); `save` writes the
    milestone as its `save_and_sample` does."""

    def __init__(self, cfg):
        self.cfg = cfg
        model, self.diffusion = j_build(cfg)
        x = jnp.zeros((2, cfg.latent_size, cfg.latent_size,
                       cfg.latent_channels))
        params = fill(jax.eval_shape(
            model.init, {"params": jax.random.PRNGKey(0)}, x,
            jnp.zeros((2,), jnp.int32), jnp.zeros((2,), jnp.int32),
            cond_drop_mask=jnp.zeros((2,), bool)), cfg.seed)
        optimizer = j_ldm_optimizer(
            learning_rate=cfg.train_lr, weight_decay=cfg.weight_decay,
            betas=cfg.adam_betas, max_grad_norm=cfg.max_grad_norm or None,
            warmup_steps=cfg.warmup_steps if cfg.use_lr_warmup else 0,
            gradient_accumulate_every=cfg.gradient_accumulate_every)
        self.train_step = j_ldm_train_step(
            self.diffusion, optimizer, cond_drop_prob=cfg.cond_drop_prob,
            ema_decay=cfg.ema_decay, ema_update_every=cfg.ema_update_every,
            donate=False)
        self.state = JLDMState(step=jnp.asarray(0), params=params,
                               opt_state=optimizer.init(params),
                               ema_params=jax.tree.map(jnp.copy, params))
        self.rng = jax.random.PRNGKey(cfg.seed + 1)

    def step(self, latents, labels):
        self.state, log = self.train_step(
            self.state, jnp.asarray(latents), jnp.asarray(labels), self.rng)
        return {k: float(v) for k, v in jax.device_get(log).items()}

    def save(self, milestone):
        JCheckpointManager(self.cfg.results_folder, prefix="model").save(
            milestone, jax.device_get(self.state),
            config=dataclasses.asdict(self.cfg))

    def draws(self, shape):
        return jax_draws(self.rng, int(self.state.step), shape,
                         self.cfg.timesteps)


def ldm_run(cfg, convert, before: int, seed: int):
    """`before` JAX steps, the milestone, and the next two steps: their
    batches, draws and logs, and the parameters and EMA (port names)
    at the milestone and after."""
    j = JaxLDM(cfg)
    rng = np.random.default_rng(seed)
    shape = (cfg.train_batch_size, cfg.latent_size, cfg.latent_size,
             cfg.latent_channels)

    def batch():
        return (rng.standard_normal(shape).astype(np.float32),
                rng.integers(0, cfg.num_users, shape[0]).astype(np.int32))

    for _ in range(before):
        latents, labels = batch()
        j.state, _ = j.train_step(j.state, jnp.asarray(latents),
                                  jnp.asarray(labels), j.rng)
    j.save(1)
    saved = jax.device_get(j.state)
    batches, draws, logs = [], [], []
    for _ in range(2):
        batches.append(batch())
        draws.append(j.draws(shape))
        logs.append(j.step(*batches[-1]))
    after = jax.device_get(j.state)
    return {"root": Path(cfg.results_folder), "saved": saved,
            "batches": batches, "draws": draws,
            "logs": {k: [log[k] for log in logs] for k in ("loss",
                                                           "grad_norm")},
            "before": (convert(saved.params), convert(saved.ema_params)),
            "params": convert(after.params), "ema": convert(after.ema_params)}


@pytest.fixture(scope="module")
def ldm_jax(tmp_path_factory):
    root = tmp_path_factory.mktemp("ldm_jax")
    cfg = JLDMConfig(**LDM_TINY, results_folder=str(root))
    run = ldm_run(cfg, cfg_unet_state_from_jax, LDM_BEFORE, 0)
    opt_state = run["saved"].opt_state
    assert int(opt_state.mini_step) == 1  # mid-accumulation
    assert int(opt_state.inner_opt_state[1][0].count) == 52  # in the warmup
    return run


@pytest.mark.parametrize("mode", ["step", "scan"])
def test_ldm_resumes_a_jax_state_and_steps_as_jax(ldm_jax, mode):
    cfg = port_config(LDMConfig, ldm_jax["root"], "model")
    trainer = LatentDiffusionTrainer(cfg, device="cpu", step_mode=mode)
    assert trainer.load() == LDM_BEFORE
    opt = trainer.optimizer
    assert type(opt).__name__ == ("CapturableOptimizer" if mode == "scan"
                                  else "LDMOptimizer")
    count = int(opt.count_t) if mode == "scan" else opt.count
    mini = int(opt.mini_t) if mode == "scan" else opt.mini_step
    assert (count, mini) == (52, 1)
    latents = torch.from_numpy(np.stack([b[0] for b in ldm_jax["batches"]]))
    labels = torch.from_numpy(np.stack([b[1] for b in ldm_jax["batches"]]))
    t = torch.from_numpy(np.stack([d[0] for d in ldm_jax["draws"]])).long()
    noise = torch.from_numpy(np.stack([d[1] for d in ldm_jax["draws"]]))
    if mode == "step":
        logs = [trainer.train_step(trainer.state, latents[i], labels[i].long(),
                                   generator=trainer.generator, t=t[i],
                                   noise=noise[i]) for i in range(2)]
        got = {k: [float(log[k]) for log in logs] for k in ldm_jax["logs"]}
    else:
        logs = trainer.scan_step(trainer.state, latents, labels.long(),
                                 generator=trainer.generator, t=t,
                                 noise=noise)
        got = {k: logs[k].tolist() for k in ldm_jax["logs"]}
    assert trainer.state.step == LDM_BEFORE + 2
    assert_logs(got, ldm_jax["logs"], mode)
    assert_moves(trainer.model.state_dict(), ldm_jax["params"],
                 ldm_jax["before"][0], LR, f"{mode} params")
    assert_moves(trainer.ema_model.state_dict(), ldm_jax["ema"],
                 ldm_jax["before"][1], LR, f"{mode} EMA")


def test_ldm_resumes_a_jax_state_under_fsdp_on_two_ranks(ldm_jax):
    raw = json.loads((ldm_jax["root"] / "model-1.config.json").read_text())
    ranks = spawn(workers.resumed_steps, 2,
                  ({**raw, "results_folder": str(ldm_jax["root"])}, "fsdp",
                   256, ldm_jax["batches"], ldm_jax["draws"]),
                  timeout=SPAWN_TIMEOUT, threads=2)
    got = ranks[0]
    assert got["start"] == LDM_BEFORE and got["step"] == LDM_BEFORE + 2
    assert got["split"] > 5  # the moments and weights held in pieces
    assert ranks[1]["logs"] == got["logs"]
    assert_logs({k: [log[k] for log in got["logs"]]
                 for k in ldm_jax["logs"]}, ldm_jax["logs"], "fsdp")
    assert_moves(got["model"], ldm_jax["params"], ldm_jax["before"][0], LR,
                 "fsdp params")
    assert_moves(got["ema"], ldm_jax["ema"], ldm_jax["before"][1], LR,
                 "fsdp EMA")


def test_the_committed_fixture_through_phase_8s_resume_on_the_cpu():
    import chip_smoke
    from vqgan_tpu_torch.kernels import KERNELS

    counts, metrics = chip_smoke.check_jax_resume(torch, KERNELS, "cpu")
    assert counts == {}  # no kernel launches on the CPU
    assert set(metrics["resume_s"]) == {"ldm_step", "ldm_scan",
                                        "vqgan_split"}
    assert max(metrics["log_rel_err"].values()) < RTOL
    assert metrics["move_err_x_lr"]["ldm_step"] < MOVE
    assert metrics["vqgan_moves_beyond"] <= VQ_MOVE_MISS


# --- DiT, and train_latent_cfg --model_type dit ----------------------------


@pytest.fixture(scope="module")
def dit_jax(tmp_path_factory):
    """The JAX trainer's DiT milestone after 3 steps, and its next two."""
    root = tmp_path_factory.mktemp("dit_jax")
    cfg = JLDMConfig(**DIT_TINY, results_folder=str(root))
    return ldm_run(cfg, dit_state_from_jax, 3, 4)


def test_dit_resumes_a_jax_state_and_steps_as_jax(dit_jax):
    cfg = port_config(LDMConfig, dit_jax["root"], "model")
    trainer = LatentDiffusionTrainer(cfg, device="cpu")
    assert type(trainer.model).__name__ == "DiT"
    assert trainer.load() == 3
    logs = [trainer.train_step(trainer.state, torch.from_numpy(latents),
                               torch.from_numpy(labels).long(),
                               generator=trainer.generator,
                               t=torch.from_numpy(t).long(),
                               noise=torch.from_numpy(noise))
            for (latents, labels), (t, noise) in zip(dit_jax["batches"],
                                                     dit_jax["draws"])]
    assert_logs({k: [float(log[k]) for log in logs] for k in dit_jax["logs"]},
                dit_jax["logs"], "dit")
    assert_moves(trainer.model.state_dict(), dit_jax["params"],
                 dit_jax["before"][0], LR, "dit params")


def test_train_latent_cfg_resumes_a_jax_dit_milestone(dit_jax, tmp_path,
                                                      capsys):
    results = tmp_path / "res"
    shutil.copytree(dit_jax["root"], results)
    split = write_latents(tmp_path, DIT_TINY["latent_size"])
    config = tmp_path / "config.json"
    config.write_text(json.dumps({**DIT_TINY, "train_num_steps": 4}))
    out = train_latent_cfg.main([
        "--device", "cpu", "--config", str(config), "--split", str(split),
        "--latents_cache_folder", str(tmp_path / "cache"),
        "--results_folder", str(results), "--resume", "-1"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"]).all()
    assert (results / "model-2.pt").exists()
    again = LatentDiffusionTrainer(port_config(LDMConfig, results, "model"),
                                   device="cpu")
    assert again.load() == 4
    assert torch.equal(again.model.state_dict()["pos_emb"],
                       out["trainer"].model.state_dict()["pos_emb"])


# --- the other three CLIs ---------------------------------------------------


def test_train_stage1_diffusers_resumes_a_jax_milestone(tmp_path, capsys):
    results = tmp_path / "res"
    split = write_latents(tmp_path, 4)
    argv = ["--device", "cpu", "--split", str(split),
            "--latents_cache_folder", str(tmp_path / "cache"),
            "--output_dir", str(results), "--resolution", "32",
            "--num_classes", "3", "--model_dim", "16", "--dim_mults", "1,2",
            "--attention_head_dim", "16", "--train_batch_size", "4",
            "--checkpointing_steps", "2", "--num_inference_steps", "3",
            "--mixed_precision", "no", "--max_train_steps", "4"]
    cfg = train_stage1_diffusers.build_config(
        train_stage1_diffusers.parse_args(argv))
    jcfg = JLDMConfig(**dataclasses.asdict(cfg))
    model, _ = j_build(jcfg)
    x = jnp.zeros((1, cfg.latent_size, cfg.latent_size, cfg.latent_channels))
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0)},
                            x, jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1,), jnp.int32),
                            cond_drop_mask=jnp.zeros((1,), bool))
    params = fill(shapes, 5)
    tx = j_ldm_optimizer(
        learning_rate=cfg.train_lr, weight_decay=cfg.weight_decay,
        betas=cfg.adam_betas, max_grad_norm=cfg.max_grad_norm or None,
        warmup_steps=cfg.warmup_steps if cfg.use_lr_warmup else 0,
        gradient_accumulate_every=cfg.gradient_accumulate_every)
    state = JLDMState(step=jnp.asarray(2), params=params,
                      opt_state=optax_state(tx, params, 2, 6),
                      ema_params=fill(shapes, 7))
    JCheckpointManager(results, prefix="model").save(
        1, jax.device_get(state), config=dataclasses.asdict(jcfg))
    out = train_stage1_diffusers.main(
        [*argv, "--resume_from_checkpoint", "latest"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["trainer"].optimizer.count == 4
    assert (results / "model-2.pt").exists()
    again = LatentDiffusionTrainer(cfg, device="cpu")
    assert again.load() == 4 and again.optimizer.count == 4


# --- refusals ---------------------------------------------------------------


@pytest.fixture
def fixture_ldm(tmp_path):
    """A copy of the committed LDM milestone (AdamW, clipping, a constant
    rate, no accumulation) and its config."""
    root = tmp_path / "ldm"
    shutil.copytree(FIXTURE / "ldm", root)
    return root, port_config(LDMConfig, root, "model")


def test_an_adamw_optimizer_refuses_an_adam_tree(fixture_ldm):
    root, cfg = fixture_ldm
    tree = read_orbax(root / "model-1")
    adam_tree = tree["opt_state"]
    adam_tree[1] = [adam_tree[1][0], adam_tree[1][2]]  # optax.adam's chain
    trainer = LatentDiffusionTrainer(cfg, device="cpu")
    with pytest.raises(ValueError, match=r"opt_state\.1: .*adamw .* 3 "
                                         r"states; .* 2 states .*no weight "
                                         r"decay"):
        optimizer_state_from_jax(adam_tree, trainer.optimizer, trainer.model)
    plain = make_ldm_optimizer(trainer.model.parameters(), weight_decay=0.0)
    out = optimizer_state_from_jax(adam_tree, plain, trainer.model)
    assert out["count"] == 2 and len(out["inner"]["state"]) == 112


def test_a_leaf_missing_from_mu_is_named(fixture_ldm):
    root, cfg = fixture_ldm
    tree = read_orbax(root / "model-1")
    del tree["opt_state"][1][0]["mu"]["params"]["final_conv"]["bias"]
    trainer = LatentDiffusionTrainer(cfg, device="cpu")
    with pytest.raises(ValueError, match=r"opt_state\.1\.0\.mu\.params\."
                                         r"final_conv\.bias is missing"):
        train_state_from_jax(tree, trainer.state)


def test_a_schedule_count_that_disagrees_with_adams_raises(fixture_ldm):
    root, cfg = fixture_ldm
    warm = dataclasses.replace(cfg, use_lr_warmup=True, warmup_steps=10)
    trainer = LatentDiffusionTrainer(warm, device="cpu")
    tree = read_orbax(root / "model-1")
    with pytest.raises(ValueError, match="ScaleByScheduleState.*constant"):
        train_state_from_jax(tree, trainer.state)
    tree["opt_state"][1][2] = {"count": np.asarray(5, np.int32)}
    with pytest.raises(ValueError, match="schedule's count 5 disagrees with "
                                         "Adam's count 2"):
        train_state_from_jax(tree, trainer.state)
    tree["opt_state"][1][2] = {"count": np.asarray(2, np.int32)}
    trainer.state.load_state_dict(train_state_from_jax(tree, trainer.state))
    assert trainer.optimizer.count == 2
    assert trainer.optimizer.lr_at(2) == pytest.approx(warm.train_lr * 0.2)


def test_multisteps_and_a_plain_chain_refuse_each_other(fixture_ldm,
                                                        ldm_jax):
    root, cfg = fixture_ldm
    accumulating = LatentDiffusionTrainer(
        dataclasses.replace(cfg, gradient_accumulate_every=2), device="cpu")
    with pytest.raises(ValueError, match="accumulates 2 .* no "
                                         "MultiStepsState"):
        accumulating.ckpt.restore(state=accumulating.state)
    plain = LatentDiffusionTrainer(dataclasses.replace(
        port_config(LDMConfig, ldm_jax["root"], "model"),
        gradient_accumulate_every=1), device="cpu")
    with pytest.raises(ValueError, match="MultiSteps' .* one gradient"):
        plain.ckpt.restore(state=plain.state)


def test_restore_of_a_jax_milestone_needs_the_state(fixture_ldm):
    root, _ = fixture_ldm
    with pytest.raises(ValueError, match=r"restore\(state=\)"):
        CheckpointManager(root, prefix="model").restore()
    (root / "model-7").mkdir()  # a directory Orbax did not write
    with pytest.raises(ValueError, match="not an Orbax checkpoint"):
        CheckpointManager(root, prefix="model").restore(7, state=object())


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
