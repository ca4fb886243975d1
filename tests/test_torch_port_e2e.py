"""The port's end-to-end demo (vqgan_tpu_torch/e2e_demo.py) and latent audit
(vqgan_tpu_torch/diagnose_latent_range.py) against cli/e2e_demo.py and
cli/diagnose_latent_range.py.

- `invalidated_stages` and `collect_summary` equal the JAX CLI's, for
  every stage and on the workspaces of tests/test_e2e_summary.py.
- The audit's latent statistics equal the JAX CLI's (1e-5 relative) on the
  same image files and the same weights (a port state dict, which the JAX
  CLI reads through its torch importer): the default KL-VAE and the
  default VQ-VAE at 32 px; its advice and codebook lines are the same.
- A `--device cpu` run of the demo's data, split, kl_vae (2 steps) and
  vae_report stages at 32 px writes its report and nothing under
  results/.
"""

import copy
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vqgan_tpu.models import KLVAE as JKLVAE
from vqgan_tpu.models import VQVAE as JVQVAE
from vqgan_tpu.models.autoencoder import AutoencoderConfig as JConfig
from vqgan_tpu_torch import diagnose_latent_range, e2e_demo
from vqgan_tpu_torch.checkpoint.from_jax import (
    klvae_state_from_jax,
    vqvae_state_from_jax,
)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "cli"))

import diagnose_latent_range as j_diagnose  # noqa: E402
import e2e_demo as j_e2e  # noqa: E402

torch.set_num_threads(2)

# ------------------------------------------------- summary and invalidation


@pytest.mark.parametrize("ran", [
    *({s} for s in j_e2e.STAGE_DEPS), set(), {"kl_vae", "vae_report"},
    {"vqgan", "ldm"}, set(j_e2e.STAGE_DEPS)], ids=lambda r: "+".join(
        sorted(r)) or "none")
def test_invalidated_stages_match_jax(ran):
    assert e2e_demo.invalidated_stages(ran) == j_e2e.invalidated_stages(ran)


def test_stage_tables_match_jax():
    assert e2e_demo.STAGE_DEPS == j_e2e.STAGE_DEPS
    assert e2e_demo.SUMMARY_STAGE == j_e2e.SUMMARY_STAGE


def _ws(tmp_path, *, vae=True, classifier=True, gen=0, serving=0):
    """The workspaces of tests/test_e2e_summary.py."""
    ws = tmp_path
    if vae:
        vr = ws / "vae_reconstruction"
        vr.mkdir(parents=True, exist_ok=True)
        (vr / "metrics.json").write_text(json.dumps(
            {"mean_psnr": 31.2, "mean_ssim": 0.93, "verdict": "very good"}))
    if classifier:
        (ws / "classifier_real.json").write_text('{"accuracy": 0.44}')
        (ws / "classifier_synth.json").write_text('{"accuracy": 0.55}')
    gen_dir = ws / "generated"
    for i in range(gen):
        d = gen_dir / "ID_1"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"generated_{i:03d}.jpg").write_bytes(b"x")
    for i in range(serving):
        d = ws / "serving" / "generated" / "ID_1"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"generated_{i:03d}.jpg").write_bytes(b"x")
    return ws, gen_dir


_STALE = {"summary": {"vae_psnr": 27.0, "classifier_acc_real": 0.4,
                      "generated_images": 5}, "summary_provenance": {}}
# (workspace, report before, stages that ran): the cases of
# tests/test_e2e_summary.py
SUMMARY_CASES = {
    "fresh": (dict(gen=3, serving=2),
              {"summary": {}, "summary_provenance": {}},
              {"vae_report", "classifier", "generate", "serving"}),
    "upstream_rerun": (dict(gen=5), _STALE, {"kl_vae"}),
    "partial_refresh": (dict(gen=5), _STALE, {"kl_vae", "vae_report"}),
    "absent_carried": (
        dict(classifier=False),
        {"summary": {"vae_psnr": 27.0, "classifier_acc_real": 0.4},
         "summary_provenance": {"classifier_acc_real": {
             "stage": "classifier", "measured_at": "BEFORE"}}},
        set()),
    "carried_stale": (dict(vae=False, classifier=False),
                      {"summary": {"classifier_acc_real": 0.4},
                       "summary_provenance": {}}, {"ldm"}),
    "serving_only": (dict(serving=2, vae=False, classifier=False),
                     {"summary": {}, "summary_provenance": {}},
                     {"serving"}),
}


@pytest.mark.parametrize("case", sorted(SUMMARY_CASES))
def test_collect_summary_matches_jax(tmp_path, case):
    layout, report, ran = SUMMARY_CASES[case]
    ws, gen_dir = _ws(tmp_path, **layout)
    ours, theirs = copy.deepcopy(report), copy.deepcopy(report)
    e2e_demo.collect_summary(ws, ours, ran=set(ran), gen_dir=gen_dir,
                             now="NOW")
    j_e2e.collect_summary(ws, theirs, ran=set(ran), gen_dir=gen_dir,
                          now="NOW")
    assert ours == theirs


# ------------------------------------------------------------ the audit


def random_params(module, *args, seed=0):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)
    out = {}
    for path, sds in flatten_dict(shapes).items():
        n = rng.standard_normal(sds.shape).astype(np.float32)
        if path[-1] == "kernel":
            n /= np.sqrt(np.prod(sds.shape[:-1]))
        elif path[-1] == "scale":
            n = 1.0 + 0.05 * n
        elif path[-1] == "bias":
            n *= 0.05
        out[path] = n
    return unflatten_dict(out)


def _images(root: Path, n=20, size=40):
    from PIL import Image

    rng = np.random.default_rng(3)
    for i in range(n):
        d = root / f"ID_{i % 3 + 1}"
        d.mkdir(parents=True, exist_ok=True)
        arr = (rng.random((size, size, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(d / f"frame_{i:03d}.png")
    return root


def _run_jax_cli(monkeypatch, argv):
    """Run cli/diagnose_latent_range.py's main; returns (its latents, its
    stdout)."""
    captured = []

    class Recorder:
        def __getattr__(self, name):
            return getattr(np, name)

        def concatenate(self, arrays, *a, **k):
            captured.append(np.concatenate(arrays, *a, **k))
            return captured[-1]

    monkeypatch.setattr(j_diagnose, "np", Recorder())
    monkeypatch.setattr(sys, "argv", ["diagnose_latent_range.py", *argv])
    out = io.StringIO()
    with redirect_stdout(out):
        j_diagnose.main()
    return captured[0], out.getvalue()


def _lines(text, *starts):
    return [ln.strip() for ln in text.splitlines()
            if ln.strip().startswith(starts)]


@pytest.mark.parametrize("kind", ["kl_vae", "vq_vae"])
def test_diagnose_matches_the_jax_cli(tmp_path, monkeypatch, capsys, kind):
    data = _images(tmp_path / "images")
    size = 32
    if kind == "kl_vae":
        jnet = JKLVAE(config=JConfig(resolution=size))
        state = klvae_state_from_jax(random_params(
            jnet, jnp.zeros((1, size, size, 3))))
        flag = "--vae_path"
    else:
        jnet = JVQVAE(resolution=size)
        state = vqvae_state_from_jax(random_params(
            jnet, jnp.zeros((1, size, size, 3))))
        flag = "--vqgan_path"
    weights = tmp_path / "weights.pt"
    torch.save(state, weights)
    argv = [flag, str(weights), "--data_path", str(data), "--num_images",
            "18", "--image_size", str(size)]

    ours = diagnose_latent_range.main([*argv, "--device", "cpu"])
    our_out = capsys.readouterr().out
    lat, their_out = _run_jax_cli(monkeypatch, argv)
    want = diagnose_latent_range.latent_stats(lat)
    assert ours["images"] == len(lat) == 18
    largest = max(abs(want["min"]), abs(want["max"]))
    for key, value in want.items():
        np.testing.assert_allclose(ours["latents"][key], value, rtol=1e-5,
                                   atol=1e-5 * largest, err_msg=key)
    assert ours["advice"] == diagnose_latent_range.normalization_advice(want)
    starts = ("latents over", "latents already", "latents in",
              "latents outside", "codebook:")
    assert _lines(our_out, *starts) == _lines(their_out, *starts)
    if kind == "vq_vae":
        assert ours["codebook"]["shape"] == [128, 256]
        assert len(_lines(our_out, "codebook:")) == 1
    else:
        assert ours["codebook"] is None


# ------------------------------------------------------- the demo on a CPU


def test_demo_stages_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)
    results = REPO / "results"
    before = sorted(p for p in results.rglob("*"))
    report = e2e_demo.main([
        "--root", str(tmp_path / "e2e"), "--num_users", "3",
        "--imgs_per_user", "8", "--image_size", "32", "--vae_steps", "2",
        "--stages", "data", "split", "kl_vae", "vae_report",
        "--device", "cpu"])
    on_disk = json.loads((tmp_path / "e2e" / "e2e_demo.json").read_text())
    assert on_disk == json.loads(json.dumps(report))
    for stage in ("data", "split", "kl_vae", "vae_report"):
        assert report["stages"][stage]["status"] == "ok"
        assert report["stages"][stage]["seconds"] > 0
    assert report["stages"]["data"]["images"] == 24
    assert (tmp_path / "e2e" / "kl_vae" / "kl_vae-1.pt").exists()
    metrics = json.loads((tmp_path / "e2e" / "vae_reconstruction"
                          / "metrics.json").read_text())
    summary = report["summary"]
    assert summary["vae_psnr"] == metrics["mean_psnr"]
    assert np.isfinite(summary["vae_psnr"]) and summary["vae_verdict"]
    assert report["summary_provenance"]["vae_psnr"]["stage"] == "vae_report"
    assert sorted(p for p in results.rglob("*")) == before

    # a second run finds every artifact and re-runs nothing
    again = e2e_demo.main([
        "--root", str(tmp_path / "e2e"), "--num_users", "3",
        "--imgs_per_user", "8", "--image_size", "32", "--vae_steps", "2",
        "--stages", "data", "split", "kl_vae", "vae_report",
        "--device", "cpu"])
    assert again["stages"] == report["stages"]
    assert again["summary"] == summary
