"""Port parity: the data and eval tools on either side of KL-VAE training
(vqgan_tpu_torch/data/splits.py, eval/metrics.py, create_data_split.py,
preprocess_latents.py, vae_reconstruction.py) against the JAX package.

- `mse`, `psnr`, `ssim_simplified` and the windowed `ssim` against
  vqgan_tpu/eval/metrics.py on the same images.
- `uniform_indices`, `create_data_split` and `verify_split` against
  vqgan_tpu/data/splits.py: a folder with uneven counts per user, a
  missing user and files that are not images; crafted bad splits.
- `preprocess_latents --device cpu` at 32 px with the default KL-VAE
  topology, its weights from a numpy seed in JAX and carried over with
  `klvae_state_from_jax`: the split equals JAX's and the cache holds JAX's
  `encode_images_mean` of the same images.
- `vae_reconstruction --device cpu`: the picks, and metrics.json against
  JAX's round trip and metrics.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from PIL import Image

from vqgan_tpu.data import load_image as j_load_image
from vqgan_tpu.data import splits as jsplits
from vqgan_tpu.eval import metrics as jmetrics
from vqgan_tpu.models import KLVAE as JKLVAE
from vqgan_tpu.models.autoencoder import AutoencoderConfig as JConfig
from vqgan_tpu_torch import create_data_split as create_cli
from vqgan_tpu_torch import preprocess_latents, vae_reconstruction
from vqgan_tpu_torch.checkpoint import klvae_state_from_jax
from vqgan_tpu_torch.data import LatentCache, load_split, splits
from vqgan_tpu_torch.eval import metrics

torch.set_num_threads(2)

# elementwise fp32 statistics summed in other orders (means over ~3k
# values, a 121-tap window)
METRIC_ATOL = 1e-6
# the default KL-VAE's encoder (~30 fp32 conv layers with GroupNorm) on
# the CPU in two summation orders; latents of O(0.1-1)
LATENT_ATOL = 2e-5
# per-image report metrics of the round trip through encoder and decoder:
# MSE of O(0.1) to 1e-4 of itself; PSNR to 1e-3 dB (1e-4 relative MSE is
# 4e-4 dB); simplified SSIM to 1e-4
REPORT_MSE_RTOL, REPORT_PSNR_ATOL, REPORT_SSIM_ATOL = 1e-4, 1e-3, 1e-4
SIZE = 32


@pytest.fixture(scope="module")
def image_pairs():
    rng = np.random.default_rng(0)
    a = rng.random((3, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    return a, b


@pytest.mark.parametrize("name", ["mse", "psnr", "ssim_simplified", "ssim"])
def test_metrics_match_jax(image_pairs, name):
    a, b = image_pairs
    want = np.asarray(getattr(jmetrics, name)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(metrics, name)(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (3,)
    rtol = 1e-6 if name in ("mse", "psnr") else 0
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=0 if rtol else METRIC_ATOL)


@pytest.mark.parametrize("n_total,n_pick", [
    (10, 3), (50, 50), (7, 50), (100, 50), (5, 4), (13, 12), (0, 3)])
def test_uniform_indices_match_jax(n_total, n_pick):
    got = splits.uniform_indices(n_total, n_pick)
    np.testing.assert_array_equal(got, jsplits.uniform_indices(n_total,
                                                               n_pick))
    assert len(got) == min(n_total, n_pick) and len(set(got)) == len(got)


def write_folder(root, counts, size=(40, 48)):
    """ID_u folders with counts[u] JPGs each (written out of order, one
    with an upper-case extension), plus a stray text file in each."""
    rng = np.random.default_rng(1)
    for user, n in counts.items():
        folder = root / f"ID_{user}"
        folder.mkdir(parents=True)
        for i in rng.permutation(n):
            ext = ".JPG" if i == 1 else ".jpg"
            Image.fromarray(rng.integers(0, 255, (*size, 3),
                                         dtype=np.uint8)).save(
                folder / f"frame_{i:03d}{ext}", format="JPEG")
        (folder / "notes.txt").write_text("not an image")
    return root


def test_create_data_split_matches_jax(tmp_path, capsys):
    # user 3 is missing; the others hold fewer, as many and more images
    # than the 5 training picks
    root = write_folder(tmp_path / "images", {1: 3, 2: 5, 4: 12, 5: 9})
    got = splits.create_data_split(root, num_users=5,
                                   images_per_user_train=5, seed=7)
    want = jsplits.create_data_split(root, num_users=5,
                                     images_per_user_train=5, seed=7)
    assert got == want
    assert sorted(got["users"]) == ["ID_1", "ID_2", "ID_4", "ID_5"]
    assert got["users"]["ID_4"]["train_indices"] == [0, 2, 5, 8, 11]
    assert "missing user directory" in capsys.readouterr().out
    assert splits.verify_split(got) == []


def _bad_splits():
    ok = {"train_images": ["a", "b"], "test_images": ["c"],
          "total_images": 3}
    return {
        "duplicates": {"ID_1": {**ok, "train_images": ["a", "a"],
                                "test_images": ["c", "c"],
                                "total_images": 4}},
        "overlap": {"ID_1": {**ok, "test_images": ["b", "c"],
                             "total_images": 4}},
        "counts": {"ID_1": {**ok, "total_images": 5}, "ID_2": ok},
        "gmm_lists": {"ID_2": {**ok, "gen_train_images": ["a", "a", "c"],
                               "class_train_images": ["a", "c"]}},
        "gen_class_overlap": {"ID_3": {**ok, "gen_train_images": ["a"],
                                       "class_train_images": ["a", "b"]}},
        "sound": {"ID_1": ok, "ID_2": {"train_images": ["x"],
                                       "test_images": []}},
    }


@pytest.mark.parametrize("case", sorted(_bad_splits()))
def test_verify_split_matches_jax(case):
    split = {"metadata": {}, "users": _bad_splits()[case]}
    got = splits.verify_split(split)
    assert got == jsplits.verify_split(split)
    assert bool(got) == (case != "sound")


def test_create_data_split_cli_writes_and_verifies(tmp_path, capsys):
    root = write_folder(tmp_path / "images", {1: 4, 2: 6})
    out = tmp_path / "split.json"
    create_cli.main(["--data_path", str(root), "--output", str(out),
                     "--num_users", "2", "--images_per_user_train", "3"])
    assert load_split(out) == jsplits.create_data_split(root, 2, 3, 42)
    create_cli.main(["--data_path", "unused", "--output", str(out),
                     "--verify"])
    assert "split OK: 2 users, 6 train / 4 test images" in \
        capsys.readouterr().out
    bad = load_split(out)
    bad["users"]["ID_2"]["test_images"].append(
        bad["users"]["ID_2"]["train_images"][0])
    out.write_text(json.dumps(bad))
    with pytest.raises(SystemExit) as stop:
        create_cli.main(["--data_path", "unused", "--output", str(out),
                         "--verify"])
    assert stop.value.code == 1
    assert "ID_2: train/test overlap" in capsys.readouterr().out


@pytest.fixture(scope="module")
def default_vae(tmp_path_factory):
    """The default KL-VAE topology at 32 px in JAX, its parameters from a
    numpy seed, and the same weights as a reference-format `.pt` file."""
    jvae = JKLVAE(config=JConfig(resolution=SIZE, z_channels=4))
    shapes = jax.eval_shape(jvae.init, {"params": jax.random.PRNGKey(0),
                                        "gaussian": jax.random.PRNGKey(1)},
                            jnp.zeros((1, SIZE, SIZE, 3)))
    rng = np.random.default_rng(3)
    flat = {}
    for path, sds in flatten_dict(shapes).items():
        n = rng.standard_normal(sds.shape).astype(np.float32)
        if path[-1] == "kernel":
            n /= np.sqrt(np.prod(sds.shape[:-1]))
        elif path[-1] == "scale":
            n = 1.0 + 0.05 * n
        elif path[-1] == "bias":
            n *= 0.05
        flat[path] = n
    params = unflatten_dict(flat)
    path = tmp_path_factory.mktemp("vae") / "kl_vae_best.pt"
    torch.save({"model_state_dict": klvae_state_from_jax(params)}, path)
    data = write_folder(tmp_path_factory.mktemp("data") / "images",
                        {1: 5, 2: 3, 3: 7})
    return jvae, params, path, data


def test_preprocess_latents_matches_jax(default_vae, tmp_path, capsys):
    jvae, params, vae_path, data = default_vae
    out_split, cache_dir = tmp_path / "split.json", tmp_path / "cache"
    result = preprocess_latents.main([
        "--device", "cpu", "--vae_path", str(vae_path), "--data_path",
        str(data), "--output_split", str(out_split), "--cache_folder",
        str(cache_dir), "--num_users", "4", "--images_per_user_train", "4",
        "--image_size", str(SIZE), "--batch_size", "4"])
    want_split = jsplits.create_data_split(data, 4, 4, 42)
    assert load_split(out_split) == want_split == result["split"]
    assert result["encoded"] == 15  # train and test, 4 batches, last of 3
    cache = LatentCache(cache_dir)
    encode = jax.jit(lambda x: jvae.apply(
        params, x, method=JKLVAE.encode_images_mean))
    for user, info in want_split["users"].items():
        label = int(user.split("_")[1]) - 1
        names = info["train_images"] + info["test_images"]
        images = np.stack([j_load_image(data / user / n, SIZE)
                           for n in names])
        want = np.asarray(encode(jnp.asarray(images)))
        got = np.stack([cache.load(label, n) for n in names])
        assert got.shape == (len(names), 4, 4, 4) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=LATENT_ATOL,
                                   err_msg=user)
    # a second run finds every latent cached and encodes none
    again = preprocess_latents.main([
        "--device", "cpu", "--vae_path", str(vae_path), "--data_path",
        str(data), "--output_split", str(out_split), "--cache_folder",
        str(cache_dir), "--num_users", "4", "--images_per_user_train", "4",
        "--image_size", str(SIZE)])
    assert again["encoded"] == 0
    assert "encoding 0 images" in capsys.readouterr().out


def test_an_orbax_directory_is_refused(default_vae, tmp_path):
    _, _, _, data = default_vae
    orbax_dir = tmp_path / "kl_vae-3"
    orbax_dir.mkdir()
    with pytest.raises(ValueError, match="Orbax"):
        preprocess_latents.main([
            "--device", "cpu", "--vae_path", str(orbax_dir), "--data_path",
            str(data), "--output_split", str(tmp_path / "s.json"),
            "--cache_folder", str(tmp_path / "cache"), "--image_size",
            str(SIZE)])


def test_vae_reconstruction_matches_jax(default_vae, tmp_path):
    jvae, params, vae_path, data = default_vae
    out = tmp_path / "report"
    result = vae_reconstruction.main([
        "--device", "cpu", "--vae_path", str(vae_path), "--data_path",
        str(data), "--image_size", str(SIZE), "--num_images", "6",
        "--output_dir", str(out), "--seed", "5"])
    saved = json.loads((out / "metrics.json").read_text())
    assert saved == result

    files = sorted(p for p in data.rglob("*")
                   if p.suffix.lower() in jsplits.IMAGE_EXTENSIONS)
    picks = np.random.default_rng(5).choice(len(files), 6, replace=False)
    x = jnp.asarray(np.stack([j_load_image(files[i], SIZE) for i in picks]))
    recon = jvae.apply(params, jvae.apply(
        params, x, method=JKLVAE.encode_images_mean),
        method=JKLVAE.decode_latents)
    np.testing.assert_allclose(saved["mse"],
                               np.asarray(jmetrics.mse(x, recon)),
                               rtol=REPORT_MSE_RTOL)
    np.testing.assert_allclose(saved["psnr"],
                               np.asarray(jmetrics.psnr(x, recon)),
                               atol=REPORT_PSNR_ATOL)
    np.testing.assert_allclose(saved["ssim"],
                               np.asarray(jmetrics.ssim_simplified(x, recon)),
                               atol=REPORT_SSIM_ATOL)
    assert saved["mean_psnr"] == pytest.approx(np.mean(saved["psnr"]))
    assert saved["verdict"] == vae_reconstruction.verdict(
        saved["mean_psnr"], saved["mean_ssim"])
    with Image.open(out / "reconstructions.png") as grid:
        assert grid.size == (2 * SIZE, 6 * SIZE)


@pytest.mark.parametrize("psnr,ssim,word", [
    (31.0, 0.95, "very good"), (31.0, 0.89, "medium"),
    (27.0, 0.95, "medium"), (25.0, 0.95, "bad"), (31.0, 0.85, "bad")])
def test_verdict_thresholds_are_the_reference_report_s(psnr, ssim, word):
    assert vae_reconstruction.verdict(psnr, ssim).startswith(word)


def test_device_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module in (preprocess_latents, vae_reconstruction):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main(["--vae_path", str(tmp_path / "v.pt"),
                         "--data_path", str(tmp_path)])
