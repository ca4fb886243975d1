"""The port's gradient checkpointing and its Diffusers-style stage-2 trainer
(`python -m vqgan_tpu_torch.train_stage1_diffusers`) against the JAX
package's (cli/train_stage1_diffusers.py), on the CPU.

- Remat: with and without gradient checkpointing, the loss and every
  gradient are equal bit for bit at cond_drop_prob 0.5 from one generator
  seed (the class dropout is drawn before the checkpoint), for the CFG
  U-Net and the DiT; and they match JAX's
  `build_cfg_unet_diffusion(..., gradient_checkpointing=True)` on the same
  weights, t, noise and mask.
- The CLI builds the same LDMConfig as the JAX CLI from the same
  arguments (the JAX trainer class is replaced by one that records its
  config), and resumes the same milestone.
- The CLI refuses the same argument errors, its defaults among them: the
  JAX CLI's rule that every level's channels divide by the head dim
  refuses model_dim 96 with head dim 64.
- A 3-step run with gradient checkpointing, milestones and sample grids,
  then a resume from "latest".
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vqgan_tpu.configs import LDMConfig as JLDMConfig
from vqgan_tpu.training.ldm_trainer import (
    build_cfg_unet_diffusion as j_build,
)
from vqgan_tpu_torch import train_stage1_diffusers
from vqgan_tpu_torch.build import Rematerialized, build_cfg_unet_diffusion
from vqgan_tpu_torch.checkpoint import (
    CheckpointManager,
    cfg_unet_state_from_jax,
    dit_state_from_jax,
)
from vqgan_tpu_torch.configs import LDMConfig
from vqgan_tpu_torch.data import LatentCache, save_split
from vqgan_tpu_torch.models import KLVAE
from vqgan_tpu_torch.models.autoencoder import AutoencoderConfig

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = {
    "unet": dict(model_type="unet", dim=16, dim_mults=(1, 2), attn_heads=2,
                 attn_dim_head=16),
    "dit": dict(model_type="dit", dim=8, attn_heads=2, attn_dim_head=16,
                dit_depth=2),
}
COMMON = dict(num_users=3, latent_size=8, image_size=64, timesteps=20,
              sampling_timesteps=5,
              cond_drop_prob=0.5, compute_dtype="float32")
FROM_JAX = {"unet": cfg_unet_state_from_jax, "dit": dit_state_from_jax}
B = 4


def random_params(module, seed=0):
    """Parameter tree from jax.eval_shape, filled from a numpy seed."""
    x = jnp.zeros((1, 8, 8, 4))
    i = jnp.zeros((1,), jnp.int32)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x, i, i,
                            cond_drop_mask=jnp.zeros((1,), bool))
    rng = np.random.default_rng(seed)
    out = {}
    for path, sds in flatten_dict(shapes).items():
        n = rng.standard_normal(sds.shape).astype(np.float32)
        if path[-1] == "kernel":
            n /= np.sqrt(np.prod(sds.shape[:-1]))
        elif path[-1] in ("scale", "g"):
            n = 1.0 + 0.05 * n
        elif path[-1] in ("bias", "pos_emb"):
            n *= 0.05
        out[path] = n
    return unflatten_dict(out)


def port_pair(model_type, remat, state):
    model, diffusion = build_cfg_unet_diffusion(
        LDMConfig(**TINY[model_type], **COMMON), device="cpu",
        gradient_checkpointing=remat)
    model.load_state_dict(state)
    return model.train(), diffusion


def grads_of(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


@pytest.mark.parametrize("model_type", ["unet", "dit"])
def test_remat_gradients_equal_plain_ones_bit_for_bit(model_type):
    jmodel, _ = j_build(JLDMConfig(**TINY[model_type], **COMMON))
    state = FROM_JAX[model_type](random_params(jmodel))
    img = np.random.default_rng(1).standard_normal((B, 8, 8, 4)).astype(
        np.float32)
    classes = torch.tensor([0, 2, 1, 2])
    out = {}
    for remat in (False, True):
        model, diffusion = port_pair(model_type, remat, state)
        assert isinstance(diffusion.model, Rematerialized) == remat
        # t, the noise and the class dropout (p 0.5) from one generator;
        # seed 8 drops classes 1 and 3 of the 4
        loss = diffusion.loss(img, classes, cond_drop_prob=0.5,
                              generator=torch.Generator().manual_seed(8))
        loss.backward()
        out[remat] = loss.detach(), grads_of(model)
    (loss, grads), (r_loss, r_grads) = out[False], out[True]
    assert torch.equal(loss, r_loss)
    assert grads.keys() == r_grads.keys()
    for name, g in grads.items():
        assert torch.equal(g, r_grads[name]), name
    # the dropout drew a mask with both values: the null embedding got a
    # gradient, and so did the class embedding
    assert grads["null_classes_emb"].abs().max() > 0
    assert grads["classes_emb.weight"].abs().max() > 0


@pytest.mark.parametrize("model_type", ["unet", "dit"])
def test_remat_gradients_match_jax(model_type):
    jcfg = JLDMConfig(**TINY[model_type], **COMMON, min_snr_loss_weight=True)
    jmodel, jdiff = j_build(jcfg, gradient_checkpointing=True)
    params = random_params(jmodel, seed=2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 8, 8, 4)).astype(np.float32)
    noise = rng.standard_normal((B, 8, 8, 4)).astype(np.float32)
    t = np.array([19, 7, 0, 11], np.int32)
    classes = np.array([2, 0, 1, 1], np.int32)
    mask = np.array([True, False, False, True])
    remat_apply = jdiff.model_apply

    def model_apply(p, x, t, classes, cond_drop_mask=None, **kw):
        return remat_apply(p, x, t, classes, cond_drop_mask=mask, **kw)

    jdiff = dataclasses.replace(jdiff, model_apply=model_apply)
    j_loss, j_grads = jax.jit(jax.value_and_grad(lambda p: jdiff.p_losses(
        p, jax.random.PRNGKey(0), x, t, classes, noise=noise)))(params)

    model, diffusion = port_pair(model_type, True,
                                 FROM_JAX[model_type](params))
    loss = diffusion.p_losses(x, torch.from_numpy(t).long(),
                              torch.from_numpy(classes).long(), noise=noise,
                              cond_drop_mask=torch.from_numpy(mask))
    loss.backward()
    # the tolerances of tests/test_torch_port_train.py: an fp32 forward
    # (rtol 1e-5 on the loss) and an fp32 backward in other summation
    # orders (gradients atol 2e-5)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    want = FROM_JAX[model_type](jax.tree.map(np.asarray, j_grads))
    for name, p in model.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        torch.testing.assert_close(got, want[name], rtol=1e-4, atol=2e-5,
                                   msg=lambda m: f"{name}: {m}")


def _jax_cli():
    sys.path.insert(0, str(REPO / "cli"))
    try:
        import train_stage1_diffusers as jcli
    finally:
        sys.path.pop(0)
    return jcli


class Recorder:
    """Stands in for a trainer class: records the config, the
    gradient-checkpointing flag and the milestone loaded; trains nothing."""

    def __init__(self, calls):
        self.calls = calls

    def __call__(self, config, split_path=None, **kw):
        call = {"config": config, "split": split_path,
                "remat": kw.get("gradient_checkpointing")}
        self.calls.append(call)

        class Trainer:
            optimizer = None

            def load(self, milestone=None):
                call["load"] = milestone
                return 0

            def train(self, num_steps=None):
                return {"losses": [], "latents_per_s": None}

        return Trainer()


# at its defaults (model_dim 96, head dim 64) each CLI refuses to run (see
# BAD below): the head dim of 32 is the one change from them
ARGVS = [
    ["--attention_head_dim", "32"],
    ["--attention_head_dim", "32", "--gradient_checkpointing",
     "--resume_from_checkpoint", "latest", "--split", "s.json",
     "--data_dir", "data", "--output_dir", "out"],
    ["--attention_head_dim", "32", "--no-use_ema", "--prediction_type",
     "epsilon", "--mixed_precision", "no", "--snr_gamma", "0",
     "--lr_warmup_steps", "0", "--resume_from_checkpoint", "3",
     "--train_batch_size", "6"],
    ["--dim_mults", "1,2", "--attention_head_dim", "32,32", "--model_dim",
     "64", "--num_classes", "5", "--resolution", "128",
     "--num_inference_steps", "20", "--checkpointing_steps", "7",
     "--ema_decay", "0.99", "--learning_rate", "3e-4", "--seed", "3",
     "--gradient_accumulation_steps", "2", "--max_train_steps", "11"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["head_dim_32", "remat_latest",
                                             "epsilon_no_ema", "narrow"])
def test_cli_maps_arguments_to_the_jax_clis_config(argv, monkeypatch):
    import vqgan_tpu.training.ldm_trainer as jtrainer
    import vqgan_tpu_torch.training.ldm_trainer as ttrainer

    j_calls, t_calls = [], []
    monkeypatch.setattr(jtrainer, "LatentDiffusionTrainer", Recorder(j_calls))
    monkeypatch.setattr(ttrainer, "LatentDiffusionTrainer", Recorder(t_calls))
    monkeypatch.setattr(sys, "argv", ["train_stage1_diffusers.py", *argv])
    _jax_cli().main()
    train_stage1_diffusers.main([*argv, "--device", "cpu"])
    (j,), (t,) = j_calls, t_calls
    want = {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(j["config"]).items()}
    got = {k: list(v) if isinstance(v, tuple) else v
           for k, v in dataclasses.asdict(t["config"]).items()}
    assert got == want
    assert t["split"] == j["split"]
    assert t.get("load", "none") == j.get("load", "none")
    assert t["remat"] == ("--gradient_checkpointing" in argv)


BAD = [
    # the defaults themselves: the first level's 96 channels do not divide
    # by the default head dim of 64
    ([], "Layer 0: 96 channels not divisible by head_dim=64"),
    (["--dim_mults", "1,x"], "must be csv integers"),
    (["--attention_head_dim", "64,64"], "attention_head_dim length (2)"),
    (["--attention_head_dim", "32,64,64,64"], "must be uniform"),
    (["--model_dim", "100"], "Layer 0: 100 channels not divisible"),
    (["--attention_head_dim", "12"], "head_dim=12 must be a multiple of 8"),
]


@pytest.mark.parametrize("argv,message", BAD,
                         ids=["defaults", "csv", "length", "uniform",
                              "divisible", "multiple_of_8"])
def test_cli_refuses_the_jax_clis_argument_errors(argv, message, monkeypatch,
                                                  capsys):
    jcli = _jax_cli()
    monkeypatch.setattr(sys, "argv", ["train_stage1_diffusers.py", *argv])
    with pytest.raises(SystemExit) as j_exit:
        jcli.main()
    j_err = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as t_exit:
        train_stage1_diffusers.parse_args(argv)
    t_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert j_exit.value.code == t_exit.value.code == 2
    assert message in j_err and message in t_err
    # the same message up to the JAX CLI's note on the TPU's rule
    assert t_err.split(" (")[0] == j_err.split(" (")[0]


def write_cache(root, n_per_user=6):
    rng = np.random.default_rng(0)
    cache = LatentCache(root / "cache")
    split = {"metadata": {}, "users": {}}
    for user in (1, 2, 3):
        names = [f"frame_{i:03d}.png" for i in range(n_per_user)]
        split["users"][f"ID_{user}"] = {"train_images": names,
                                        "test_images": []}
        for name in names:
            cache.save(user - 1, name,
                       rng.standard_normal((8, 8, 4)).astype(np.float32))
    save_split(split, root / "split.json")


def test_cpu_run_with_remat_grids_and_resume(tmp_path):
    write_cache(tmp_path)
    torch.manual_seed(0)
    vae = tmp_path / "kl_vae.pt"
    torch.save(KLVAE(AutoencoderConfig(resolution=64)).state_dict(), vae)
    out = tmp_path / "results"
    argv = ["--device", "cpu", "--split", str(tmp_path / "split.json"),
            "--latents_cache_folder", str(tmp_path / "cache"),
            "--output_dir", str(out), "--pretrained_vae_path", str(vae),
            "--resolution", "64", "--num_classes", "3", "--model_dim", "16",
            "--dim_mults", "1,2", "--attention_head_dim", "16",
            "--train_batch_size", "4", "--checkpointing_steps", "2",
            "--num_inference_steps", "3", "--lr_warmup_steps", "2",
            "--mixed_precision", "no", "--gradient_checkpointing"]
    first = train_stage1_diffusers.main([*argv, "--max_train_steps", "3"])
    trainer = first.pop("trainer")
    assert isinstance(trainer.diffusion.model, Rematerialized)
    assert trainer.config.sampling_timesteps == 3
    assert len(first["losses"]) == 3 and np.isfinite(first["losses"]).all()
    ckpt = CheckpointManager(out, prefix="model")
    # a milestone at step 2 and one at the off-cadence end, with grids
    assert ckpt.all_milestones() == [1, 2] and ckpt.latest_milestone() == 2
    assert (out / "sample-1.png").exists() and (out / "sample-2.png").exists()
    saved = json.loads((out / "model-2.config.json").read_text())
    assert saved["train_batch_size"] == 4 and saved["warmup_steps"] == 2
    # the warm-up: update 0 takes lr 0, update 2 the full rate
    assert trainer.optimizer.lr_at(0) == 0.0
    assert trainer.optimizer.lr_at(2) == pytest.approx(1e-4)

    second = train_stage1_diffusers.main(
        [*argv, "--max_train_steps", "5", "--resume_from_checkpoint",
         "latest"])
    resumed = second.pop("trainer")
    assert resumed.state.step == 5 and len(second["losses"]) == 2
    assert np.isfinite(second["losses"]).all()
    assert ckpt.latest_milestone() == 3
    assert ckpt.restore()["step"] == 5
