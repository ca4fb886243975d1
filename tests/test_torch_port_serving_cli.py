"""The port's serving entry points on the CPU: the CLI tests of
tests/test_serving_export.py and tests/test_cli_smoke.py with
`--device cpu`.

- `export_serving` exports and self-tests the CFG sampler (fp32 and bf16
  weights, which print their drift) and the VQ codec from checkpoints in
  the port's layout; `--dp 2` raises.
- `serve_generate` writes the ID_X/generated_###.jpg layout.
- `serve_http --port 0` announces its port, answers /healthz (warm) and
  /generate (base64 JPEGs), and 400 for a bad request or user id.
- Argument errors exit 2; the hosts default to the card.
"""

import base64
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch
from PIL import Image

from vqgan_tpu_torch import export_serving
from vqgan_tpu_torch.checkpoint import CheckpointManager
from vqgan_tpu_torch.configs import LDMConfig, VQGANConfig
from vqgan_tpu_torch.models import KLVAE, VQVAE, CFGUnet
from vqgan_tpu_torch.models.autoencoder import AutoencoderConfig

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-5  # the JAX CLI's selftest rule (rtol 1e-4, atol 1e-5)


TINY_LDM = dict(dim=16, dim_mults=[1, 2], attn_heads=2, attn_dim_head=16,
                num_users=3, latent_size=4, image_size=32, timesteps=20,
                sampling_timesteps=3)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """An LDM results folder of the port's layout, a KL-VAE file and a
    VQ-GAN milestone, all of seeded random weights."""
    root = tmp_path_factory.mktemp("ckpt")
    torch.manual_seed(0)
    config = LDMConfig.from_dict(TINY_LDM)
    unet = CFGUnet(dim=16, num_classes=3, dim_mults=(1, 2), channels=4,
                   attn_dim_head=16, attn_heads=2)
    CheckpointManager(root / "ldm", prefix="model").save(
        1, {"step": 0, "ema": unet.state_dict()},
        config=dataclasses.asdict(config))
    torch.save(KLVAE(AutoencoderConfig(resolution=32)).state_dict(),
               root / "kl_vae.pt")
    vq_cfg = VQGANConfig(ch=8, ch_mult=(1, 2), num_res_blocks=1,
                         z_channels=8, num_embeddings=8, embedding_dim=8,
                         compute_dtype="float32", image_size=32)
    vq = VQVAE(ch=8, ch_mult=(1, 2), num_res_blocks=1, resolution=32,
               z_channels=8, num_embeddings=8, embedding_dim=8)
    CheckpointManager(root / "vqgan", prefix="vqgan").save(
        1, {"step": 0, "vqvae": vq.state_dict()},
        config=dataclasses.asdict(vq_cfg))
    return root


@pytest.fixture(scope="module")
def artifact(checkpoints):
    out = checkpoints / "artifact"
    export_serving.main([
        "--checkpoint", str(checkpoints / "ldm"), "--vae_path",
        str(checkpoints / "kl_vae.pt"), "--out", str(out), "--batch_size",
        "2", "--cond_scale", "1.0", "--device", "cpu"])
    return out


def test_export_serving_cli_selftests_on_cpu(checkpoints, tmp_path, capsys):
    common = ["--checkpoint", str(checkpoints / "ldm"), "--vae_path",
              str(checkpoints / "kl_vae.pt"), "--batch_size", "2",
              "--device", "cpu", "--selftest"]
    res = export_serving.main([*common, "--out", str(tmp_path / "f32"),
                               "--cond_scale", "3.0"])
    assert res["selftest"]["max_abs_diff"] <= ATOL
    assert res["selftest"]["bf16_drift"] is None
    meta = json.loads((tmp_path / "f32" / "meta.json").read_text())
    assert meta["config"]["dim"] == 16 and meta["num_users"] == 3
    assert len(meta["ddim_pairs"]) == 3 and meta["ddim_pairs"][-1][1] == -1
    res = export_serving.main([*common, "--out", str(tmp_path / "b16"),
                               "--params_dtype", "bfloat16"])
    assert res["selftest"]["bf16_drift"] > 0
    out = capsys.readouterr().out
    assert "bf16-weights pixel drift vs fp32 weights" in out
    assert out.count("selftest OK") == 2

    res = export_serving.main([
        "--mode", "vq_codec", "--vqgan_path",
        str(checkpoints / "vqgan" / "vqgan-1.pt"), "--out",
        str(tmp_path / "codec"), "--batch_size", "2", "--device", "cpu",
        "--selftest"])
    assert res["meta"]["index_shape"] == [2, 16, 16]
    assert res["selftest"]["recon_max_abs_diff"] <= ATOL


def test_export_serving_dp_raises(checkpoints, tmp_path):
    with pytest.raises(NotImplementedError, match="data-parallel"):
        export_serving.main([
            "--checkpoint", str(checkpoints / "ldm"), "--vae_path",
            str(checkpoints / "kl_vae.pt"), "--out", str(tmp_path), "--dp",
            "2", "--device", "cpu"])


def _env():
    return {**os.environ, "PYTHONPATH": str(REPO)}


def test_serve_generate_cli(artifact, tmp_path):
    gen = tmp_path / "generated"
    r = subprocess.run(
        [sys.executable, "-m", "vqgan_tpu_torch.serve_generate",
         "--artifact", str(artifact), "--output_dir", str(gen),
         "--num_images", "3", "--all_users", "--device", "cpu"],
        capture_output=True, text=True, timeout=600, env=_env(), cwd=REPO)
    assert r.returncode == 0, r.stderr
    for user in (1, 2, 3):
        files = sorted((gen / f"ID_{user}").glob("generated_*.jpg"))
        assert [f.name for f in files] == [
            "generated_000.jpg", "generated_001.jpg", "generated_002.jpg"]
        with Image.open(files[0]) as img:
            assert img.size == (32, 32) and img.mode == "RGB"


def test_entry_points_default_to_the_card(artifact, checkpoints,
                                         monkeypatch):
    from vqgan_tpu_torch import diagnose_latent_range, serve_generate
    from vqgan_tpu_torch.serve_http import GenerationService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # a CPU artifact asked for on the default device: without a card each
    # raises (never a quiet CPU run)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_generate.main(["--artifact", str(artifact)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationService(str(artifact))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_serving.main([
            "--checkpoint", str(checkpoints / "ldm"), "--vae_path",
            str(checkpoints / "kl_vae.pt"), "--out", "unused"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        diagnose_latent_range.main([
            "--vae_path", str(checkpoints / "kl_vae.pt"), "--data_path",
            "unused"])


def test_an_artifact_runs_only_on_its_device_type(artifact, monkeypatch):
    from vqgan_tpu_torch.serving import load_cfg_sampler

    # a card present, the artifact exported for the CPU: refused, not run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="exported on cpu"):
        load_cfg_sampler(artifact, "cuda")


def test_serve_http_daemon(artifact):
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "vqgan_tpu_torch.serve_http",
         "--artifact", str(artifact), "--port", "0", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(), cwd=REPO)
    try:
        port, deadline = None, time.time() + 300
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                raise AssertionError("server died before startup")
            m = re.search(r"serving on http://[\d.]+:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "server never announced its port"

        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok"
        assert health["batch_size"] == 2 and health["num_users"] == 3
        assert health["warm"] is True

        body = json.dumps({"user_id": 2, "num_images": 3,
                           "seed": 7}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert len(out["images"]) == 3 and out["latency_s"] > 0
        img = Image.open(io.BytesIO(base64.b64decode(out["images"][0])))
        assert img.size == (32, 32)

        for bad_body in ({"user_id": 99}, {"user_id": 0}, {"num_images": 1}):
            bad = urllib.request.Request(
                f"http://127.0.0.1:{port}/generate",
                data=json.dumps(bad_body).encode(),
                headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(bad, timeout=60)
            assert e.value.code == 400
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def _run(args):
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, timeout=600, env=_env(), cwd=REPO)


def test_serving_clis_arg_validation():
    # cfg_sampler mode demands --checkpoint and --vae_path
    r = _run(["vqgan_tpu_torch.export_serving", "--out", "/tmp/x"])
    assert r.returncode == 2
    assert "requires --checkpoint" in r.stderr
    # vq_codec mode demands --vqgan_path
    r = _run(["vqgan_tpu_torch.export_serving", "--mode", "vq_codec"])
    assert r.returncode == 2
    assert "requires --vqgan_path" in r.stderr
    # serving hosts demand --artifact
    for module in ("serve_generate", "serve_http"):
        r = _run([f"vqgan_tpu_torch.{module}"])
        assert r.returncode == 2, module
        assert "--artifact" in r.stderr
