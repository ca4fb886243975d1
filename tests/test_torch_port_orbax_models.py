"""The port's entry points on checkpoints the JAX package writes.

- Small width: an LDM results folder `model-1/` holding the train state
  the JAX `LatentDiffusionTrainer` saves (step, params, optax state,
  ema_params, with its config), for the CFG U-Net and for the DiT, loaded
  by `generate.load_checkpoint` + `load_model`; a `vqgan-1/` holding the
  JAX `VQGANTrainer`'s state, loaded by `load_vqvae`. The port's outputs
  on the same inputs are held to the JAX modules' (the tolerances of
  test_torch_port_unet, test_torch_port_dit and test_torch_port_vqvae).
  The states are built from the trainers' own types and optimizers and
  saved by the JAX `CheckpointManager` as the trainers save them; the
  weights are seeded numpy values (a trainer's init would compile for a
  minute).
- Full width, leaf for leaf: the CFG U-Net's {step, params, ema_params}
  (298 leaves each) and the KL-VAE's parameters in `train_kl_vae`'s
  layout read bit for bit as `orbax` restores them and load strictly
  into the default-width port modules; the KL-VAE's decode against JAX's.
- Each CLI that takes a KL-VAE, VQ-GAN or LDM path hands a directory to
  the shared loaders; `generate` and `diagnose_latent_range` run through.
- The committed fixture (tests/fixtures/jax_orbax/) through phase 8 of
  chip_smoke.py on the CPU, against the JAX outputs it stores.
- `CheckpointManager.restore` of a JAX milestone, given the port's train
  state, yields that state's own `state_dict()` form; a milestone in both
  forms raises.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from PIL import Image

from vqgan_tpu.checkpoint import CheckpointManager as JCheckpointManager
from vqgan_tpu.configs import LDMConfig as JLDMConfig
from vqgan_tpu.configs import VQGANConfig as JVQGANConfig
from vqgan_tpu.models import KLVAE as JKLVAE
from vqgan_tpu.models import VQVAE as JVQVAE
from vqgan_tpu.models.autoencoder import AutoencoderConfig as JAEConfig
from vqgan_tpu.models.discriminator import PatchGANDiscriminator
from vqgan_tpu.training.ldm_step import LDMTrainState, make_ldm_optimizer
from vqgan_tpu.training.ldm_trainer import build_cfg_unet_diffusion as j_build
from vqgan_tpu.training.vqgan_step import VQGANTrainState, make_gan_optimizers
from vqgan_tpu_torch import diagnose_latent_range, generate
from vqgan_tpu_torch.checkpoint import CheckpointManager
from vqgan_tpu_torch.checkpoint.from_jax import (
    cfg_unet_state_from_jax,
    klvae_state_from_jax,
    vqvae_state_from_jax,
)
from vqgan_tpu_torch.checkpoint.load import load_vqvae
from vqgan_tpu_torch.checkpoint.orbax import read_orbax
from vqgan_tpu_torch.configs import LDMConfig
from vqgan_tpu_torch.data.datasets import load_image
from vqgan_tpu_torch.training.ldm_trainer import LatentDiffusionTrainer

torch.set_num_threads(4)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_port_orbax import assert_same  # noqa: E402

TINY_UNET = dict(num_users=3, latent_size=4, image_size=32, latent_channels=4,
                 dim=16, dim_mults=(1, 2), attn_heads=2, attn_dim_head=16,
                 timesteps=20, sampling_timesteps=3, compute_dtype="float32")
TINY_DIT = {**TINY_UNET, "model_type": "dit", "dim": 8, "dit_depth": 2,
            "dit_patch_size": 2}
TINY_VQGAN = dict(image_size=32, ch=8, ch_mult=(1, 2), num_res_blocks=1,
                  z_channels=8, num_embeddings=8, embedding_dim=8,
                  disc_ndf=8, disc_n_layers=2, compute_dtype="float32")
# the tolerances of the modules' own parity tests
ATOL = {"unet": (2e-4, 1e-4), "dit": (1e-5, 1e-5), "vq_recon": (1e-5, 0),
        "kl_decode": (2e-4, 1e-4)}


def fill(shapes, seed):
    """Seeded numpy values in the shapes of a jax.eval_shape tree: kernels
    scaled by their fan-in, norms near 1, biases small."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, sds in flatten_dict(shapes).items():
        n = rng.standard_normal(sds.shape, dtype=np.float32)
        if path[-1] == "kernel":
            n /= np.sqrt(np.prod(sds.shape[:-1]))
        elif path[-1] in ("scale", "g", "var"):
            n = 1.0 + 0.05 * np.abs(n)
        elif path[-1] in ("bias", "mean"):
            n *= 0.05
        out[path] = n
    return unflatten_dict(out)


def unet_inputs(cfg, b=2, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cfg.latent_size, cfg.latent_size,
                             cfg.latent_channels)).astype(np.float32)
    return (x, np.array([3, 17][:b], np.int32),
            np.array([2, 0][:b], np.int32))


def write_ldm(root: Path, fields: dict):
    """The state the JAX LatentDiffusionTrainer saves, its params and EMA
    from different seeds. Returns (JAX model, its config, ema_params)."""
    cfg = JLDMConfig(**fields)
    model, _ = j_build(cfg)
    x, t, classes = unet_inputs(cfg, b=1)
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0)},
                            x, t, classes, cond_drop_mask=np.zeros(1, bool))
    params, ema = fill(shapes, 0), fill(shapes, 1)
    optimizer = make_ldm_optimizer(
        learning_rate=cfg.train_lr, weight_decay=cfg.weight_decay,
        betas=cfg.adam_betas, max_grad_norm=cfg.max_grad_norm or None,
        gradient_accumulate_every=cfg.gradient_accumulate_every)
    state = LDMTrainState(step=jnp.asarray(5), params=params,
                          opt_state=optimizer.init(params), ema_params=ema)
    JCheckpointManager(root, prefix="model").save(
        1, jax.device_get(state), config=dataclasses.asdict(cfg))
    return model, cfg, ema


def write_vqgan(root: Path):
    """The state the JAX VQGANTrainer saves. Returns (the VQ-VAE as the
    JAX CLIs build it from the config, its params)."""
    cfg = JVQGANConfig(**TINY_VQGAN)
    vq = JVQVAE(ch=cfg.ch, ch_mult=cfg.ch_mult,
                num_res_blocks=cfg.num_res_blocks,
                attn_resolutions=cfg.attn_resolutions,
                resolution=cfg.image_size, z_channels=cfg.z_channels,
                num_embeddings=cfg.num_embeddings,
                embedding_dim=cfg.embedding_dim)
    x0 = np.zeros((1, cfg.image_size, cfg.image_size, 3), np.float32)
    vq_params = fill(jax.eval_shape(vq.init, jax.random.PRNGKey(0), x0), 2)
    disc = PatchGANDiscriminator(ndf=cfg.disc_ndf, n_layers=cfg.disc_n_layers,
                                 norm=cfg.disc_norm)
    disc_vars = fill(jax.eval_shape(disc.init, jax.random.PRNGKey(1), x0), 3)
    disc_params = {"params": disc_vars["params"]}
    opt_g, opt_d = make_gan_optimizers(
        learning_rate=cfg.learning_rate,
        disc_learning_rate=cfg.disc_learning_rate, betas=cfg.adam_betas,
        weight_decay=cfg.weight_decay, max_grad_norm=cfg.max_grad_norm or None)
    state = VQGANTrainState(
        step=jnp.asarray(3), vqvae_params=vq_params, disc_params=disc_params,
        disc_stats={"batch_stats": disc_vars["batch_stats"]},
        opt_g=opt_g.init(vq_params), opt_d=opt_d.init(disc_params))
    JCheckpointManager(root, prefix="vqgan").save(
        1, jax.device_get(state), config=dataclasses.asdict(cfg))
    return vq, vq_params


def write_full_kl_vae(root: Path):
    """A default-width KL-VAE's parameters as cli/train_kl_vae.py saves
    them. Returns (JAX model, params)."""
    vae = JKLVAE(config=JAEConfig(resolution=32, z_channels=4))
    shapes = jax.eval_shape(
        vae.init, {"params": jax.random.PRNGKey(0),
                   "gaussian": jax.random.PRNGKey(1)},
        np.zeros((1, 32, 32, 3), np.float32))
    params = fill(shapes, 4)
    JCheckpointManager(root, prefix="kl_vae").save(
        1, params, config={"image_size": 32, "latent_channels": 4,
                           "save_every": 1})
    return vae, params


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_ckpts")
    out = {"root": root}
    out["unet"] = (root / "ldm", *write_ldm(root / "ldm", TINY_UNET))
    out["dit"] = (root / "ldm_dit", *write_ldm(root / "ldm_dit", TINY_DIT))
    out["vqgan"] = (root / "vqgan", *write_vqgan(root / "vqgan"))
    out["kl_vae"] = (root / "kl_vae",
                     *write_full_kl_vae(root / "kl_vae"))
    images = root / "images" / "ID_1"
    images.mkdir(parents=True)
    rng = np.random.default_rng(6)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)
                        ).save(images / f"f{i}.jpg")
    return out


@pytest.mark.parametrize("backbone", ["unet", "dit"])
def test_generate_loads_the_backbone_and_ema_of_a_jax_results_folder(
        dirs, backbone):
    root, jmodel, cfg, ema = dirs[backbone]
    config, weights = generate.load_checkpoint(root)
    assert weights == root / "model-1" and config.model_type == cfg.model_type
    diffusion, model = generate.load_model(config, weights, "cpu")
    assert type(model).__name__ == ("DiT" if backbone == "dit" else "CFGUnet")
    x, t, classes = unet_inputs(cfg)
    mask = np.array([False, True])
    want = jax.jit(jmodel.apply)(ema, x, t, classes, cond_drop_mask=mask)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2),
                           torch.from_numpy(t).long(),
                           torch.from_numpy(classes).long(),
                           cond_drop_mask=torch.from_numpy(mask))
    atol, rtol = ATOL[backbone]
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=atol, rtol=rtol)


def test_load_vqvae_reads_a_jax_vqgan_milestone(dirs):
    root, jvq, params = dirs["vqgan"]
    vqvae, cfg = load_vqvae(root / "vqgan-1", device="cpu")
    assert (cfg.ch, cfg.ch_mult, cfg.image_size) == (8, (1, 2), 32)
    x = np.random.default_rng(7).random((2, 32, 32, 3)).astype(np.float32)
    want_idx = jax.jit(lambda p, x: jvq.apply(
        p, x, method=JVQVAE.encode_to_indices))(params, x)
    want = jax.jit(lambda p, i: jvq.apply(
        p, i, method=JVQVAE.decode_from_indices))(params, want_idx)
    with torch.no_grad():
        idx = vqvae.encode_to_indices(torch.from_numpy(x).permute(0, 3, 1, 2))
        recon = vqvae.decode_from_indices(idx).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    atol, rtol = ATOL["vq_recon"]
    np.testing.assert_allclose(recon.numpy(), np.asarray(want), atol=atol,
                               rtol=rtol)


def test_full_width_unet_and_kl_vae_read_bit_for_bit_and_load_strictly(
        dirs, tmp_path):
    cfg = JLDMConfig()
    model, _ = j_build(cfg)
    x, t, classes = unet_inputs(cfg, b=1)
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0)},
                            x, t, classes, cond_drop_mask=np.zeros(1, bool))
    params = fill(shapes, 10)
    ema = jax.tree.map(lambda a: a * np.float32(1.01), params)
    JCheckpointManager(tmp_path, prefix="model").save(
        1, {"step": np.int32(100), "params": params, "ema_params": ema},
        config=dataclasses.asdict(cfg))
    path = tmp_path / "model-1"
    got = read_orbax(path)
    assert_same(ocp.StandardCheckpointer().restore(path), got)
    assert [len(flatten_dict(got[k])) for k in ("params", "ema_params")] == [
        298, 298]
    config, weights = generate.load_checkpoint(tmp_path)
    _, unet = generate.load_model(config, weights, "cpu")  # strict
    want = cfg_unet_state_from_jax(ema)
    for k, v in unet.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert sum(v.numel() for v in unet.parameters()) == sum(
        a.size for a in jax.tree.leaves(ema))
    del got, params, ema, unet, want

    vae_dir, jvae, vparams = dirs["kl_vae"]
    path = vae_dir / "kl_vae-1"
    assert_same(ocp.StandardCheckpointer().restore(path), read_orbax(path))
    vae = generate.load_vae(path, image_size=32, device="cpu")  # strict
    want = klvae_state_from_jax(vparams)
    for k, v in vae.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert sum(v.numel() for v in vae.parameters()) == sum(
        a.size for a in jax.tree.leaves(vparams))
    z = np.random.default_rng(8).standard_normal((1, 4, 4, 4)).astype(
        np.float32)
    want_img = jax.jit(lambda p, z: jvae.apply(
        p, z, method=JKLVAE.decode_latents))(vparams, z)
    with torch.no_grad():
        got_img = vae.decode_latents(torch.from_numpy(z))
    atol, rtol = ATOL["kl_decode"]
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               atol=atol, rtol=rtol)


class _Loaded(Exception):
    """Raised by the loader spies: the CLI handed its path over."""


# each CLI that takes a KL-VAE path, with arguments that reach its loader
# ({kl}: the full-width kl_vae-1/, {ldm}: the U-Net's results folder)
_CLIS = {
    "preprocess_latents": ["--vae_path", "{kl}", "--data_path", "{img}",
                           "--output_split", "{tmp}/s.json",
                           "--cache_folder", "{tmp}/c", "--image_size", "32"],
    "preprocess_latents_with_gmm": ["--vae_path", "{kl}", "--data_path",
                                    "{img}", "--image_size", "32"],
    "vae_reconstruction": ["--vae_path", "{kl}", "--data_path", "{img}",
                           "--image_size", "32"],
    "validate_cluster_number": ["--vae_path", "{kl}", "--data_path", "{img}",
                                "--image_size", "32"],
    "train_latent_cfg": ["--vae_path", "{kl}", "--results_folder",
                         "{tmp}/r"],
    "train_stage1_diffusers": ["--pretrained_vae_path", "{kl}", "--split",
                               "{tmp}/s.json", "--latents_cache_folder",
                               "{tmp}/c", "--output_dir", "{tmp}/r",
                               "--attention_head_dim", "32"],
    "debug_ldm_pipeline": ["--vae_path", "{kl}", "--image_size", "32"],
    "diagnose_latent_range": ["--vae_path", "{kl}", "--data_path", "{img}",
                              "--image_size", "32"],
    "export_serving": ["--checkpoint", "{ldm}", "--vae_path", "{kl}",
                       "--out", "{tmp}/art"],
}


@pytest.mark.parametrize("cli", sorted(_CLIS))
def test_cli_hands_a_jax_directory_to_the_loaders(dirs, tmp_path, cli,
                                                  monkeypatch):
    import importlib

    module = importlib.import_module(f"vqgan_tpu_torch.{cli}")
    kl = dirs["kl_vae"][0] / "kl_vae-1"
    seen = []

    def spy(path, *args, **kwargs):
        seen.append(Path(path))
        raise _Loaded

    # the CLIs import load_vae from generate, at the top or in main
    monkeypatch.setattr(generate, "load_vae", spy)
    if hasattr(module, "load_vae"):
        monkeypatch.setattr(module, "load_vae", spy)
    loaded = []
    if cli == "export_serving":  # the U-Net loads before the KL-VAE
        real = module.load_model
        monkeypatch.setattr(module, "load_model", lambda *a, **k: (
            loaded.append(real(*a, **k)) or loaded[-1]))
    argv = [a.format(kl=kl, img=dirs["root"] / "images", tmp=tmp_path,
                     ldm=dirs["unet"][0]) for a in _CLIS[cli]]
    with pytest.raises(_Loaded):
        module.main([*argv, "--device", "cpu"])
    assert seen == [kl]
    if cli == "export_serving":
        (_, model), = loaded
        want = cfg_unet_state_from_jax(dirs["unet"][3])
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k]), k


def test_export_serving_vq_codec_reads_a_jax_vqgan(dirs, tmp_path,
                                                   monkeypatch):
    from vqgan_tpu_torch import export_serving

    loaded = []
    real = export_serving.load_vqvae
    monkeypatch.setattr(export_serving, "load_vqvae", lambda *a, **k: (
        loaded.append(real(*a, **k)) or loaded[-1]))
    monkeypatch.setattr(export_serving, "export_vq_codec",
                        lambda *a, **k: (_ for _ in ()).throw(_Loaded()))
    root, jvq, params = dirs["vqgan"]
    with pytest.raises(_Loaded):
        export_serving.main(["--mode", "vq_codec", "--vqgan_path",
                             str(root / "vqgan-1"), "--out",
                             str(tmp_path / "art"), "--device", "cpu"])
    (vqvae, cfg), = loaded
    assert cfg.num_embeddings == 8
    want = vqvae_state_from_jax(params)
    for k, v in vqvae.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_generate_and_diagnose_latent_range_run_on_jax_directories(
        dirs, tmp_path):
    out = tmp_path / "gen"
    result = generate.main([
        "--checkpoint", str(dirs["unet"][0]), "--vae_path",
        str(dirs["kl_vae"][0] / "kl_vae-1"), "--device", "cpu",
        "--output_dir", str(out), "--user_ids", "2", "--num_images", "1",
        "--batch_size", "1"])
    assert result["images"] == [out / "ID_2" / "generated_000.jpg"]
    with Image.open(result["images"][0]) as img:
        assert img.size == (32, 32)

    root, jvq, params = dirs["vqgan"]
    images = dirs["root"] / "images"
    report = diagnose_latent_range.main([
        "--vqgan_path", str(root / "vqgan-1"), "--data_path", str(images),
        "--image_size", "32", "--device", "cpu"])
    x = np.stack([load_image(p, 32) for p in sorted(images.rglob("*.jpg"))])
    want = np.asarray(jax.jit(lambda p, x: jvq.apply(
        p, x, method=JVQVAE.encode_images))(params, x))
    assert report["images"] == 2
    for key, fn in (("min", np.min), ("max", np.max), ("mean", np.mean),
                    ("std", np.std)):
        np.testing.assert_allclose(report["latents"][key], fn(want),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_committed_fixture_through_phase_8_on_the_cpu():
    import chip_smoke
    from vqgan_tpu_torch.kernels import KERNELS

    counts, metrics = chip_smoke.check_jax_fixture(torch, KERNELS, "cpu")
    assert counts == {}  # no kernel launches on the CPU
    assert set(metrics["reads"]) == {"ldm", "kl_vae", "vqgan"}
    assert metrics["vq_index_flips"] == 0


def test_resume_yields_the_port_state_of_a_jax_milestone_and_both_forms_raise(
        dirs, tmp_path):
    root, _, cfg, ema = dirs["unet"]
    ckpt = CheckpointManager(root, prefix="model")
    assert ckpt.all_milestones() == [1] and ckpt.latest_milestone() == 1
    assert ckpt.checked_path() == root / "model-1"
    with pytest.raises(ValueError, match=r"restore\(state=\)"):
        ckpt.restore()  # a JAX train state needs the port state it resumes
    trainer = LatentDiffusionTrainer(LDMConfig.from_dict(
        {**dataclasses.asdict(cfg), "results_folder": str(root)}),
        device="cpu")
    got = ckpt.restore(state=trainer.state)
    mine = trainer.state.state_dict()
    assert got.keys() == mine.keys() and got["step"] == 5
    for part in ("model", "ema"):
        assert got[part].keys() == mine[part].keys()
    assert torch.equal(got["ema"]["init_conv.weight"],
                        cfg_unet_state_from_jax(ema)["init_conv.weight"])
    assert got["optimizer"]["count"] == 0  # the state's optax.init
    trainer.state.load_state_dict(got)
    assert trainer.state.step == 5
    both = CheckpointManager(tmp_path, prefix="model")
    (tmp_path / "model-2").mkdir()
    torch.save({}, tmp_path / "model-2.pt")
    with pytest.raises(ValueError, match="both"):
        both.all_milestones()
    with pytest.raises(ValueError, match="both"):
        both.checked_path(2)


def test_a_module_without_a_converter_is_refused():
    from vqgan_tpu_torch.checkpoint.load import jax_state_for

    with pytest.raises(TypeError, match="no converter .* Linear"):
        jax_state_for(torch.nn.Linear(2, 2), {})
