"""The port's generation slice as a whole, and the guards that keep the port
honest.

- A full DDIM chain (T=20, 5 steps, pred_v, cosine, eta 1) with the same
  injected numpy noise through vqgan_tpu and vqgan_tpu_torch, at cond_scale
  1.0 and at 3.0 with rescaled_phi 0.7, then decode_latents.
- A CPU run of `python -m vqgan_tpu_torch.generate` writes the
  ID_X/generated_###.jpg layout.
- Entry points default to the GPU and raise without one.
- No module of the port imports JAX or the JAX package (a static scan:
  the interpreter may have imported jax already).
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from PIL import Image

from vqgan_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from vqgan_tpu.models import CFGUnet as JCFGUnet
from vqgan_tpu.models import KLVAE as JKLVAE
from vqgan_tpu.models.autoencoder import AutoencoderConfig as JConfig
from vqgan_tpu_torch.checkpoint.from_jax import (
    cfg_unet_state_from_jax,
    klvae_state_from_jax,
)
from vqgan_tpu_torch.diffusion import GaussianDiffusion
from vqgan_tpu_torch.models import CFGUnet, KLVAE
from vqgan_tpu_torch.models.autoencoder import AutoencoderConfig

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
UNET = dict(dim=16, num_classes=3, cond_drop_prob=0.0, dim_mults=(1, 2),
            channels=4, attn_dim_head=16, attn_heads=2)
VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
           resolution=16, z_channels=4)
DIFF = dict(image_size=8, channels=4, timesteps=20, sampling_timesteps=5,
            objective="pred_v", beta_schedule="cosine", auto_normalize=False)
B = 3


def random_params(module, *args, seed=0, **kwargs):
    """Parameter tree from jax.eval_shape, filled from a numpy seed."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args,
                            **kwargs)
    rng = np.random.default_rng(seed)
    out = {}
    for path, sds in flatten_dict(shapes).items():
        n = rng.standard_normal(sds.shape).astype(np.float32)
        if path[-1] == "kernel":
            n /= np.sqrt(np.prod(sds.shape[:-1]))
        elif path[-1] in ("scale", "g"):
            n = 1.0 + 0.05 * n
        elif path[-1] == "bias":
            n *= 0.05
        out[path] = n
    return unflatten_dict(out)


@pytest.fixture(scope="module")
def pipelines():
    jnet = JCFGUnet(**UNET)
    uparams = random_params(jnet, jnp.zeros((1, 8, 8, 4)),
                            jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1,), jnp.int32),
                            cond_drop_mask=jnp.zeros((1,), bool), seed=0)
    jvae = JKLVAE(config=JConfig(**VAE))
    vparams = random_params(jvae, jnp.zeros((1, 16, 16, 3)), seed=1)

    def model_apply(p, x, t, classes, cond_drop_mask=None, **_):
        return jnet.apply(p, x, t, classes, cond_drop_mask=cond_drop_mask)

    jdiff = JGaussianDiffusion(model_apply, **DIFF)

    tnet = CFGUnet(**UNET).eval()
    tnet.load_state_dict(cfg_unet_state_from_jax(uparams))
    tvae = KLVAE(AutoencoderConfig(**VAE)).eval()
    tvae.load_state_dict(klvae_state_from_jax(vparams))
    tdiff = GaussianDiffusion(tnet, **DIFF, device="cpu")
    return (jdiff, uparams, jvae, vparams), (tdiff, tvae)


@pytest.mark.parametrize("cond_scale,phi", [(1.0, 0.0), (3.0, 0.7)])
def test_ddim_chain_and_decode_match_jax(pipelines, cond_scale, phi):
    (jdiff, uparams, jvae, vparams), (tdiff, tvae) = pipelines
    rng = np.random.default_rng(2)
    shape = (B, 8, 8, 4)
    init = rng.standard_normal(shape).astype(np.float32)
    steps = rng.standard_normal((5, *shape)).astype(np.float32)
    classes = np.array([0, 2, 1], np.int32)

    @jax.jit
    def j_pipeline(up, vp, init, steps, classes):
        z = jdiff.ddim_sample(up, jax.random.PRNGKey(0), shape, classes,
                              cond_scale=cond_scale, rescaled_phi=phi,
                              init_noise=init, step_noise=steps)
        return z, jvae.apply(vp, z, method=JKLVAE.decode_latents)

    j_z, j_img = j_pipeline(uparams, vparams, init, steps, classes)
    t_z = tdiff.ddim_sample(shape, torch.from_numpy(classes).long(),
                            cond_scale=cond_scale, rescaled_phi=phi,
                            init_noise=init, step_noise=steps)
    with torch.no_grad():
        t_img = tvae.decode_latents(t_z)
    assert t_z.shape == shape and t_img.shape == (B, 16, 16, 3)
    # five steps of fp32 U-Net + DDIM updates on values in [-1, 1] (x_start
    # is clipped); the DDIM coefficient c cancels near t = T (see
    # test_torch_port_core.py). Measured max difference 2e-5; 5x margin.
    np.testing.assert_allclose(t_z.numpy(), np.asarray(j_z), atol=1e-4)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-4)


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0", "pred_v"])
def test_model_predictions_match_jax(pipelines, objective):
    (jdiff, uparams, _, _), (tdiff, _) = pipelines
    kw = {**DIFF, "objective": objective}
    jd = JGaussianDiffusion(jdiff.model_apply, **kw)
    td = GaussianDiffusion(tdiff.model, **kw, device="cpu")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 8, 8, 4)).astype(np.float32)
    t = np.array([19, 7, 0], np.int32)
    classes = np.array([2, 0, 1], np.int32)
    j = jd.model_predictions(uparams, jnp.asarray(x), jnp.asarray(t),
                             jnp.asarray(classes), cond_scale=3.0,
                             rescaled_phi=0.7, clip_x_start=True)
    with torch.no_grad():
        p = td.model_predictions(
            torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(t).long(), torch.from_numpy(classes).long(),
            cond_scale=3.0, rescaled_phi=0.7, clip_x_start=True)
    # one fp32 CFG forward, then conversions that scale its rounding ~30x:
    # x_start from noise multiplies by sqrt(1/alpha) near t = T, noise from
    # x_start divides by sqrt(1/alpha - 1) near t = 0. Measured max 7e-4.
    for a, b in zip(j, p):
        np.testing.assert_allclose(b.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(a), atol=2e-3, rtol=1e-4)


def test_ddim_time_pairs_match_jax(pipelines):
    (jdiff, *_), (tdiff, _) = pipelines
    assert tdiff.ddim_time_pairs() == [
        tuple(p) for p in np.asarray(jdiff._ddim_time_pairs()).tolist()]
    assert tdiff.ddim_sampling_eta == jdiff.ddim_sampling_eta == 1.0


def test_generate_cli_writes_user_layout_on_cpu(tmp_path):
    from vqgan_tpu_torch import generate

    config = tmp_path / "config.json"
    config.write_text(json.dumps(dict(
        dim=16, dim_mults=[1, 2], attn_heads=2, attn_dim_head=16,
        num_users=3, latent_size=4, image_size=32, timesteps=20,
        sampling_timesteps=3)))
    out = tmp_path / "generated"
    result = generate.main([
        "--random_init", "--seed", "0", "--config", str(config),
        "--device", "cpu", "--output_dir", str(out), "--user_ids", "1", "3",
        "--num_images", "3", "--batch_size", "2", "--cond_scale", "3.0"])
    expected = [out / f"ID_{u}" / f"generated_{i:03d}.jpg"
                for u in (1, 3) for i in range(3)]
    assert result["images"] == expected
    # the entry point turns TF32 off for fp32 matmuls and convolutions
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert len(result["batch_seconds"]) == 4  # 2 users x batches of 2 + 1
    for path in expected:
        with Image.open(path) as img:
            assert img.size == (32, 32) and img.mode == "RGB"


def test_load_weights_unwraps_reference_containers(tmp_path):
    from vqgan_tpu_torch.checkpoint.load import load_weights

    src = CFGUnet(**UNET)
    state = src.state_dict()
    # a reference trainer checkpoint: EMA of the diffusion wrapper, with the
    # wrapper's schedule buffers beside the U-Net's parameters
    ema = {f"ema_model.model.{k}": v for k, v in state.items()}
    ema["ema_model.betas"] = torch.zeros(20)
    ema["step"] = torch.tensor(3)
    torch.save({"step": 3, "model": {}, "ema": ema}, tmp_path / "model.pt")
    torch.save(state, tmp_path / "raw.pt")
    for name in ("model.pt", "raw.pt"):
        dst = load_weights(CFGUnet(**UNET), tmp_path / name)
        for k, v in dst.state_dict().items():
            torch.testing.assert_close(v, state[k], rtol=0, atol=0)
    torch.save({k: v for k, v in list(state.items())[1:]},
               tmp_path / "short.pt")
    with pytest.raises(KeyError, match="lacks 1"):
        load_weights(CFGUnet(**UNET), tmp_path / "short.pt")


def test_entry_points_default_to_gpu_and_raise_without_one(monkeypatch,
                                                          tmp_path):
    from vqgan_tpu_torch import (
        bench_attention,
        bench_vq,
        generate,
        profile_generate,
        profile_sampling,
        profile_training,
        profile_vqgan_train,
        train_vqgan,
    )
    from vqgan_tpu_torch.build import build_cfg_unet_diffusion
    from vqgan_tpu_torch.configs import LDMConfig, VQGANConfig
    from vqgan_tpu_torch.training.vqgan_trainer import VQGANTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_cfg_unet_diffusion(LDMConfig(dim=16, dim_mults=(1, 2)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.load_vae()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main(["--random_init", "--output_dir", "unused"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_generate.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vqgan.main(["--results_folder", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VQGANTrainer(VQGANConfig(ch=8, ch_mult=(1, 2),
                                 results_folder=str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_vqgan_train.main([])
    for tool in (bench_attention, bench_vq, profile_training,
                 profile_sampling):  # the measurement tools
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main([])


def test_time_sampling_times_each_sampler_and_raises_without_a_gpu(
        monkeypatch):
    from vqgan_tpu_torch import time_sampling
    from vqgan_tpu_torch.configs import LDMConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        time_sampling.main([])

    # the same loops on the CPU at a tiny width
    tiny = dict(dim=16, dim_mults=(1, 2), attn_heads=2, attn_dim_head=16,
                latent_size=4, image_size=32, timesteps=20,
                sampling_timesteps=3, dit_depth=2, num_users=3)
    monkeypatch.setattr(time_sampling, "LDMConfig",
                        lambda **kw: LDMConfig(**{**tiny, **kw}))
    monkeypatch.setattr(time_sampling, "resolve_device",
                        lambda device: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *args: "cpu")
    out = time_sampling.main(["--batch_size", "2", "--dit_batches", "2"])
    assert len(out["dit_generate_s"]) == 2 and len(out["ddim_step_ms"]) == 3
    assert all(v > 0 for v in [*out["dit_generate_s"], out["ancestral_s"],
                               *out["ddim_step_ms"]])
    # launches are counted on the card only
    assert out["dit_generate_launches"] == out["ancestral_launches"] == {}


def test_profile_steps_reads_every_wall_time_before_any_profiled_run(
        monkeypatch):
    # once torch.profiler has run in a process, every later launch costs
    # more host time: the profile entry points time every step they report
    # first, and only then run the profiled repeats
    from types import SimpleNamespace

    from vqgan_tpu_torch import profile_generate

    events = []
    profiling = []

    class Recorder:
        def __init__(self, *args, **kwargs):
            pass

        def __enter__(self):
            events.append("profile")
            profiling.append(True)
            return self

        def __exit__(self, *exc):
            profiling.pop()
            return False

        def key_averages(self):
            return []

    clock = iter(range(0, 1000, 3))

    def perf_counter():
        events.append("clock")
        return next(clock)

    monkeypatch.setattr(profile_generate, "profile", Recorder)
    monkeypatch.setattr(profile_generate, "time",
                        SimpleNamespace(perf_counter=perf_counter))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *args: events.append("sync"))

    def step(label):
        return lambda: events.append((label, bool(profiling)))

    out = profile_generate.profile_steps({"g": (step("g"), 3),
                                          "g_and_d": (step("g_and_d"), 2)})
    first = events.index("profile")
    assert "clock" not in events[first:]

    def timed(label, reps):
        # a warm-up call, then the repeats between two clock reads, each
        # after a synchronise
        return [(label, False), "sync", "clock", *[(label, False)] * reps,
                "sync", "clock"]

    assert events[:first] == timed("g", 3) + timed("g_and_d", 2)
    assert events[first:] == ["profile", *[("g", True)] * 3, "sync",
                              "profile", *[("g_and_d", True)] * 2, "sync"]
    assert out["g"]["wall_ms"] == pytest.approx(3e3 / 3)
    assert out["g_and_d"]["wall_ms"] == pytest.approx(3e3 / 2)
    assert out["g"]["device_ms"] is None


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "zarr",
              "ml_dtypes", "vqgan_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p.relative_to(REPO).as_posix()
    for p in [*(REPO / "vqgan_tpu_torch").rglob("*.py"),
              REPO / "chip_smoke.py", REPO / "tests" / "dp_check.py",
              REPO / "tests" / "tp_serve_check.py"]))
def test_port_imports_no_jax(path):
    bad = [name for name in _imported_roots(REPO / path)
           if name.split(".")[0] in _FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
