"""Port parity: the trainers over the native input pipeline, and the data
CLIs, against the JAX package, on the CPU.

- VQ-GAN (`native_input` True, tiny fp32 config, disc_start 1): the port's
  trainer and JAX's, from the same weights (carried with the
  checkpoint/from_jax.py maps), read the same ring batches in the same
  order over 3 steps, and log the same losses (rtol 1e-4, the split steps'
  parity rule).
- LDM over a fully cached split: both read through the native latent
  batcher ("using native latent batch loader"), the same batches; with
  JAX's t and noise injected into the port's steps, the same losses
  (rtol 1e-4, the whole-step rule of test_torch_port_train.py).
- DDPM `Trainer` on a `FolderDataset` of JPGs: the same ring batches as the
  JAX trainer's loader; a `Dataset1D` keeps the Python BatchLoader.
- Each trainer names its loader in its result; the Python loader where the
  dataset does not fit the ring.
- `load_dataset --test_load` prints what the JAX CLI prints;
  `debug_ldm_pipeline --device cpu` runs its checks on a tiny KL-VAE;
  `bench_decode` and `bench_input_pipeline` print their JSON lines;
  `StepTimer` and `trace` work on the CPU.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vqgan_tpu.configs import LDMConfig as JLDMConfig
from vqgan_tpu.configs import VQGANConfig as JVQGANConfig
from vqgan_tpu.training.ddpm_trainer import FolderDataset as JFolderDataset
from vqgan_tpu.training.ddpm_trainer import Trainer as JDDPMTrainer
from vqgan_tpu.training.ldm_trainer import LatentDiffusionTrainer as JLDM
from vqgan_tpu.training.vqgan_trainer import VQGANTrainer as JVQGANTrainer
from vqgan_tpu_torch.checkpoint import (
    cfg_unet_state_from_jax,
    lpips_state_from_jax,
    patchgan_state_from_jax,
    vqvae_state_from_jax,
)
from vqgan_tpu_torch.configs import LDMConfig, VQGANConfig
from vqgan_tpu_torch.data import LatentCache, save_split
from vqgan_tpu_torch.training.ddpm_trainer import FolderDataset, Trainer
from vqgan_tpu_torch.training.ldm_trainer import LatentDiffusionTrainer
from vqgan_tpu_torch.training.vqgan_trainer import VQGANTrainer

from _jax_native_libs import jax_native_libs  # noqa: F401

torch.set_num_threads(2)

# every test waits until the JAX package's native libraries load
pytestmark = pytest.mark.usefixtures("jax_native_libs")
REPO = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-4


def write_jpg_users(root, users=3, per_user=4, size=40, seed=0):
    """ID_1..ID_users with per_user seeded JPGs and a split listing them."""
    rng = np.random.default_rng(seed)
    split = {"metadata": {"method": "test"}, "users": {}}
    for u in range(1, users + 1):
        names = [f"f{i:02d}.jpg" for i in range(per_user)]
        (root / f"ID_{u}").mkdir(parents=True)
        for name in names:
            Image.fromarray(rng.integers(0, 255, (size, size, 3),
                                         dtype=np.uint8)).save(
                root / f"ID_{u}" / name)
        split["users"][f"ID_{u}"] = {"train_images": names,
                                     "test_images": names[:1]}
    (root / "split.json").write_text(json.dumps(split))
    return root / "split.json"


def read_log(path, key):
    return [json.loads(line)[key] for line in path.read_text().splitlines()]


def spy_on(obj, name, record, pick):
    """Replace obj.name by a wrapper that appends pick(*args) to record."""
    inner = getattr(obj, name)

    def spy(*args, **kwargs):
        record.append(pick(*args))
        return inner(*args, **kwargs)

    setattr(obj, name, spy)


# --- VQ-GAN -----------------------------------------------------------------

VQ_TINY = dict(num_users=3, images_per_user_train=4, ch=16, ch_mult=(1, 2),
               num_res_blocks=1, z_channels=16, num_embeddings=8,
               embedding_dim=16, disc_ndf=8, disc_n_layers=2,
               compute_dtype="float32", image_size=32, batch_size=2,
               disc_start=1, save_and_sample_every=1000, seed=3,
               native_input=True)


def test_vqgan_trainer_reads_the_ring_and_matches_jax(tmp_path):
    split = write_jpg_users(tmp_path / "data")
    kw = dict(VQ_TINY, data_path=str(tmp_path / "data"))
    j = JVQGANTrainer(JVQGANConfig(**kw, results_folder=str(tmp_path / "j")),
                      split_path=str(split), use_mesh=False)
    t = VQGANTrainer(VQGANConfig(**kw, results_folder=str(tmp_path / "t")),
                     split_path=str(split), device="cpu")
    assert type(j.loader).__name__ == type(t.loader).__name__ == \
        "NativeBatchLoader"
    assert t.loader_kind == "native_ring"
    np_tree = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    t.vqvae.load_state_dict(vqvae_state_from_jax(np_tree(
        j.state.vqvae_params)))
    t.disc.load_state_dict(patchgan_state_from_jax(np_tree(
        {**j.state.disc_params, **j.state.disc_stats})))
    t.lpips.load_state_dict(lpips_state_from_jax(np_tree(j.lpips_params)))

    j_seen, t_seen = [], []
    spy_on(j, "dispatch_step", j_seen, lambda s, images, step: (
        step, np.asarray(images)))
    spy_on(t, "dispatch_step", t_seen, lambda images, step: (
        step, images.numpy().copy()))
    j.train(num_steps=3, log_every=1)
    out = t.train(num_steps=3, log_every=1)

    assert [s for s, _ in t_seen] == [s for s, _ in j_seen] == [0, 1, 2]
    for (_, a), (_, b) in zip(t_seen, j_seen):
        np.testing.assert_array_equal(a, b)
    assert out["loader"] == "native_ring"
    want = read_log(tmp_path / "j" / "vqgan.jsonl", "loss_total")
    np.testing.assert_allclose(out["losses"], want, rtol=LOSS_RTOL)
    # every logged loss of each step (the G-only step 0 logs no d_loss)
    rows = [[json.loads(line) for line in (tmp_path / side / "vqgan.jsonl")
             .read_text().splitlines()] for side in ("t", "j")]
    for step, (got, row) in enumerate(zip(*rows)):
        keys = {k for k in row if "loss" in k}
        assert keys == {k for k in got if "loss" in k}
        assert ("d_loss" in keys) == (step >= 1)
        for key in keys:
            np.testing.assert_allclose(got[key], row[key], rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=f"{step} {key}")


def test_vqgan_trainer_names_the_python_loader(tmp_path):
    split = write_jpg_users(tmp_path / "data")
    cfg = VQGANConfig(**dict(VQ_TINY, native_input=False),
                      data_path=str(tmp_path / "data"),
                      results_folder=str(tmp_path / "t"))
    t = VQGANTrainer(cfg, split_path=str(split), device="cpu")
    assert t.loader_kind == "native_get_batch"  # get_batch decodes natively
    assert t.train(num_steps=1)["loader"] == "native_get_batch"
    cfg.native_input = "auto"
    # scan mode draws through the same prefetcher
    t = VQGANTrainer(cfg, split_path=str(split), device="cpu",
                     step_mode="scan", scan_block=2)
    out = t.train(num_steps=3, log_every=0)
    assert len(out["losses"]) == 3 and out["loader"] == "native_ring"


# --- LDM --------------------------------------------------------------------

LDM_TINY = dict(dim=16, dim_mults=(1, 2), attn_heads=2, attn_dim_head=16,
                num_users=3, latent_size=4, image_size=32, timesteps=20,
                sampling_timesteps=3, images_per_user_train=5,
                save_and_sample_every=1000, train_batch_size=4, seed=5,
                compute_dtype="float32")


def write_latent_split(root, per_user=7):
    rng = np.random.default_rng(1)
    cache = LatentCache(root / "cache")
    split = {"metadata": {}, "users": {}}
    for user in (1, 2, 3):
        names = [f"frame_{i:03d}.png" for i in range(per_user)]
        split["users"][f"ID_{user}"] = {"train_images": names,
                                        "test_images": []}
        for name in names:
            cache.save(user - 1, name,
                       rng.standard_normal((4, 4, 4)).astype(np.float32))
    save_split(split, root / "split.json")
    return root / "split.json"


def test_ldm_trainer_reads_native_latents_and_matches_jax(tmp_path, capsys):
    split = write_latent_split(tmp_path)
    kw = dict(LDM_TINY, latents_cache_folder=str(tmp_path / "cache"),
              data_path=str(tmp_path / "images"))
    j = JLDM(JLDMConfig(**kw, results_folder=str(tmp_path / "j")),
             split_path=str(split), use_mesh=False)
    t = LatentDiffusionTrainer(
        LDMConfig(**kw, results_folder=str(tmp_path / "t")),
        split_path=str(split), device="cpu")
    state = cfg_unet_state_from_jax(jax.tree.map(np.asarray, j.state.params))
    t.model.load_state_dict(state)
    t.ema_model.load_state_dict(state)

    j_seen, t_seen = [], []
    spy_on(j, "train_step", j_seen, lambda state, lat, lab, rng: (
        np.asarray(lat), np.asarray(lab)))
    inner = t.train_step
    timesteps, b = LDM_TINY["timesteps"], LDM_TINY["train_batch_size"]

    def injected(state, latents, labels, generator=None):
        """The port's step with the draws of JAX's step at this step."""
        t_seen.append((latents.numpy().copy(), labels.numpy().copy()))
        key = jax.random.fold_in(jax.random.PRNGKey(LDM_TINY["seed"] + 1),
                                 state.step)
        k_t, k_p = jax.random.split(key)
        k_noise = jax.random.split(k_p, 3)[0]
        draw_t = np.asarray(jax.random.randint(k_t, (b,), 0, timesteps))
        noise = np.asarray(jax.random.normal(k_noise, latents.shape,
                                             jnp.float32))
        return inner(state, latents, labels, generator=generator,
                     t=torch.tensor(draw_t).long(),
                     noise=torch.tensor(noise))

    t.train_step = injected
    j.train(num_steps=3, log_every=1)
    out = t.train(num_steps=3, log_every=1)

    assert capsys.readouterr().out.count(
        "using native latent batch loader") == 2
    assert out["loader"] == "native_latents" and len(t_seen) == 3
    for (a, la), (c, lc) in zip(t_seen, j_seen):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(la, lc)
    want = read_log(tmp_path / "j" / "ldm.jsonl", "loss")
    np.testing.assert_allclose(out["losses"], want, rtol=LOSS_RTOL)


def test_ldm_trainer_without_a_full_npy_cache_takes_the_batch_loader(
        tmp_path, capsys):
    split = write_latent_split(tmp_path)
    npy = tmp_path / "cache" / "user_00_frame_000.npy"
    # the item stays readable, as a reference CHW `.pt`, but is no `.npy`
    torch.save(torch.from_numpy(np.load(npy).transpose(2, 0, 1).copy()),
               npy.with_suffix(".pt"))
    npy.unlink()
    cfg = LDMConfig(**LDM_TINY, latents_cache_folder=str(tmp_path / "cache"),
                    data_path=str(tmp_path / "images"),
                    results_folder=str(tmp_path / "t"))
    t = LatentDiffusionTrainer(cfg, split_path=str(split), device="cpu")
    out = t.train(num_steps=2, log_every=0)
    assert out["loader"] == "python" and len(out["losses"]) == 2
    assert "using native latent batch loader" not in capsys.readouterr().out


# --- DDPM -------------------------------------------------------------------


def test_ddpm_trainer_reads_the_same_ring_batches_as_jax(tmp_path):
    from vqgan_tpu_torch.diffusion import GaussianDiffusion
    from vqgan_tpu_torch.models import Unet

    root = tmp_path / "images"
    write_jpg_users(root, users=2, per_user=5, size=24)
    (root / "notes.txt").write_text("not an image")
    assert [(Path(p), lab) for p, lab in FolderDataset(root, 16).items] == \
        [(Path(p), lab) for p, lab in JFolderDataset(root, 16).items]

    class Stand:  # the JAX trainer reads only the diffusion's image size
        image_size = 16

    j = JDDPMTrainer(Stand(), {"w": jnp.zeros(2)}, str(root),
                     train_batch_size=4, seed=9, use_mesh=False,
                     results_folder=str(tmp_path / "j"))
    torch.manual_seed(0)
    model = Unet(dim=8, dim_mults=(1, 2), channels=3)
    diffusion = GaussianDiffusion(model, image_size=16, timesteps=20,
                                  sampling_timesteps=3, device="cpu")
    t = Trainer(diffusion, model, str(root), train_batch_size=4,
                train_num_steps=3, num_samples=4, seed=9,
                results_folder=str(tmp_path / "t"))
    assert t.loader_kind == "native_ring"
    seen = []
    spy_on(t, "train_step", seen, lambda images: images.numpy().copy())
    out = t.train(log_every=100)
    assert out["loader"] == "native_ring" and len(out["losses"]) == 3
    j_batches = iter(j.loader)
    for got in seen:
        np.testing.assert_array_equal(got, next(j_batches)[0])


def test_ddpm_trainer_keeps_the_batch_loader_for_sequences(capsys):
    from vqgan_tpu_torch.data.native_image import (
        loader_kind,
        make_batch_loader,
    )
    from vqgan_tpu_torch.diffusion.gaussian_1d import Dataset1D

    data = np.random.default_rng(0).random((8, 2, 16)).astype(np.float32)
    # the call the DDPM Trainer makes for its dataset
    loader = make_batch_loader(Dataset1D(data), 4, shuffle=True, seed=0)
    assert type(loader).__name__ == "BatchLoader"
    assert loader_kind(loader) == "python"
    assert "Python BatchLoader" in capsys.readouterr().out
    batches = iter(loader)
    np.testing.assert_array_equal(next(batches)[0].shape, (4, 2, 16))
    batches.close()


# --- CLIs and profiling -----------------------------------------------------


def _jax_cli(name):
    sys.path.insert(0, str(REPO / "cli"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def test_load_dataset_prints_what_the_jax_cli_prints(tmp_path, capsys,
                                                     monkeypatch):
    from vqgan_tpu_torch import load_dataset

    split = write_jpg_users(tmp_path / "data")
    argv = ["--data_root", str(tmp_path / "data"), "--split", str(split),
            "--image_size", "32", "--test_load"]
    load_dataset.main(argv)
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["load_dataset.py", *argv])
    _jax_cli("load_dataset").main()
    want = capsys.readouterr().out
    assert got == want
    assert "train: batch images (4, 32, 32, 3) dtype=float32" in got
    assert "test: batch images (3, 32, 32, 3)" in got
    assert "smoke load OK" in got and "ID_3: train 4, test 1" in got


@pytest.fixture(scope="module")
def tiny_kl_vae(tmp_path_factory):
    from vqgan_tpu_torch.models import KLVAE
    from vqgan_tpu_torch.models.autoencoder import AutoencoderConfig

    root = tmp_path_factory.mktemp("vae")
    torch.manual_seed(0)
    vae = KLVAE(AutoencoderConfig(resolution=32, z_channels=4))
    torch.save(vae.state_dict(), root / "kl_vae.pt")
    write_jpg_users(root / "images", users=2, per_user=4, size=32)
    return root


def test_debug_ldm_pipeline_runs_its_checks_on_the_cpu(tiny_kl_vae, capsys):
    from vqgan_tpu_torch import debug_ldm_pipeline

    common = ["--vae_path", str(tiny_kl_vae / "kl_vae.pt"), "--image_size",
              "32", "--device", "cpu"]
    healthy = debug_ldm_pipeline.main(common)
    out = capsys.readouterr().out
    assert "random-latent decode std" in out and "invariance" in out
    assert "checkpoint loads; all" in out
    assert healthy == ("[FAIL]" not in out)
    assert ("pipeline HEALTHY" in out) == healthy
    # with images: the MSE tier; a random-init VAE reconstructs poorly
    healthy = debug_ldm_pipeline.main(
        [*common, "--data_path", str(tiny_kl_vae / "images")])
    out = capsys.readouterr().out
    line = next(s for s in out.splitlines() if "real recon MSE" in s)
    mse = float(line.split("=")[1].split()[0])
    tier = ("excellent" if mse < 0.01 else "good" if mse < 0.05 else "POOR")
    assert f"({tier})" in line
    assert healthy == (mse < 0.05 and "[FAIL]" not in out)
    # a checkpoint missing a tensor is refused
    state = torch.load(tiny_kl_vae / "kl_vae.pt", weights_only=True)
    state.pop(next(iter(state)))
    torch.save(state, tiny_kl_vae / "broken.pt")
    with pytest.raises(KeyError, match="lacks 1"):
        debug_ldm_pipeline.main(["--vae_path", str(tiny_kl_vae / "broken.pt"),
                                 "--image_size", "32", "--device", "cpu"])


def test_debug_ldm_pipeline_runs_on_the_gpu_unless_told():
    from vqgan_tpu_torch import debug_ldm_pipeline

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        debug_ldm_pipeline.main(["--vae_path", "unused.pt"])


def test_bench_decode_prints_its_json_line(capsys):
    from vqgan_tpu_torch import bench_decode

    result = bench_decode.main(["--n", "4", "--src", "40", "--size", "16",
                                "--threads", "2", "--iters", "1"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == result and last["n"] == 4
    assert last["pil_img_per_s"] > 0 and last["native_img_per_s"] > 0


def test_bench_input_pipeline_prints_one_json_line_per_loader(capsys):
    from vqgan_tpu_torch import bench_input_pipeline

    result = bench_input_pipeline.main(
        ["--n_images", "8", "--image_size", "32", "--decode_size", "16",
         "--batch", "2", "--n_batches", "3", "--step_ms", "1"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert set(result) == {"pil_batchloader", "native_get_batch",
                           "native_async_pipeline"}
    assert len(lines) == 3 and lines[0]["vs_baseline"] == 1.0
    assert all(line["unit"] == "batches/sec" and line["value"] > 0
               for line in lines)


def test_step_timer_and_trace_on_the_cpu(tmp_path):
    import time

    from vqgan_tpu_torch.utils import StepTimer, annotate, trace

    timer = StepTimer(warmup=2, ema=0.5)
    assert timer.avg_seconds is None and timer.throughput(8) is None
    assert timer.step() is None and timer.step(torch.ones(2)) is None
    time.sleep(0.01)
    dt = timer.step(sync=True)
    assert dt >= 0.01 and timer.avg_seconds == dt
    assert timer.throughput(8) == pytest.approx(8 / dt)
    with trace(tmp_path / "prof") as prof:
        with annotate("matmul"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert any(e.key == "matmul" for e in prof.key_averages())
