"""The port's measurement entry points on the CPU at small sizes:
`bench_attention`, `bench_vq` (the JAX CLI's interface), `profile_training`
and `profile_sampling`. Each writes or returns records with the keys the
JAX CLIs' records have (the compute bound renamed from the TPU's MXU to the
tensor cores), counts its FLOPs through `utils/flops.py`, and never writes
the JAX CLIs' files. On the CPU no device metric is given (MFU and bounds
are None). The card runs them at the JAX CLIs' defaults in chip_smoke.py's
phase 7; without a card each raises (`test_torch_port_generate.py`,
`test_entry_points_default_to_gpu_and_raise_without_one`).
"""

import json
from pathlib import Path

import pytest
import torch

from vqgan_tpu_torch import (
    bench_attention,
    bench_vq,
    profile_sampling,
    profile_training,
)
from vqgan_tpu_torch.configs import LDMConfig, VQGANConfig
from vqgan_tpu_torch.ops.vq import vq_lookup_reference

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ROOFLINE_KEYS = {"program", "t_measured_ms", "items_per_sec", "flops",
                 "bytes", "peak_dtype", "t_tensor_core_ms", "t_hbm_ms",
                 "mfu", "hbm_util", "kernel_launches"}


def test_bench_attention_rows_on_the_cpu():
    rows = bench_attention.main(["--device", "cpu", "--batch", "1",
                                 "--heads", "2", "--dim", "16", "--seq",
                                 "32", "--iters", "2"])
    assert [(r["route"], r["pass"]) for r in rows] == [
        (route, p) for p in ("fwd", "fwd+bwd")
        for route in ("einsum", "flash", "sdpa")]
    base = 4 * 1 * 2 * 32 * 32 * 16
    flops = {(r["route"], r["pass"]): r["flops_per_step"] for r in rows}
    assert flops["einsum", "fwd"] == flops["flash", "fwd"] == base
    # the gradient with respect to q alone: the einsum's backward skips
    # dK and dV, the port's autograd function runs both backward kernels
    assert flops["einsum", "fwd+bwd"] == 2 * base
    assert flops["flash", "fwd+bwd"] == base * 18 // 4
    for r in rows:
        assert r["ms"] > 0 and r["mfu"] is None and r["device"] == "cpu"
        assert r["launches_per_iter"] == {}  # the plain versions
        # least bytes: q, k, v (bf16) read, the output or dQ written
        assert r["bytes"] == 4 * 32 * 2 * 16 * 2
        assert r["t_tensor_core_ms"] is None
        assert r["roofline_fraction"] is None


def test_bench_vq_rows_on_the_cpu():
    rows = bench_vq.main(["--device", "cpu", "--n", "64", "--k", "16", "32",
                          "--d", "8", "--iters", "2"])
    assert [(r["k"], r["route"]) for r in rows] == [
        (k, route) for k in (16, 32)
        for route in ("library", "kernel", "kernel_fp32")]
    for r in rows:
        assert r["us"] > 0 and r["gb_per_s"] > 0
        assert r["gb_per_s"] == pytest.approx(
            (64 * 8 * 2 + r["k"] * 8) * 4 / 1e9 / (r["us"] / 1e6))
        assert r["flops_per_step"] == 2 * 64 * r["k"] * 8
        assert r["bytes"] > 0 and r["mfu"] is None
        assert r["roofline_fraction"] is None
    for k in (16, 32):
        lib, bf16, exact = (r for r in rows if r["k"] == k)
        assert torch.equal(exact["indices"].long(), lib["indices"].long())
        want = vq_lookup_reference(lib["z"], lib["codebook"], "bf16")[1]
        assert torch.equal(bf16["indices"], want)


def _records_have_the_keys(records, path):
    assert json.loads(Path(path).read_text()) == json.loads(
        json.dumps(records))
    timed = [r for r in records if "flops" in r and "t_hbm_ms" in r]
    assert timed
    for rec in timed:
        assert ROOFLINE_KEYS <= set(rec), rec["program"]
        assert rec["mfu"] is None and rec["t_tensor_core_ms"] is None
        assert rec["t_measured_ms"] > 0


def test_profile_training_records_on_the_cpu(monkeypatch, tmp_path):
    narrow = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
                  disc_ndf=8, disc_n_layers=2, compute_dtype="float32")
    monkeypatch.setattr(profile_training, "VQGANConfig",
                        lambda **kw: VQGANConfig(**{**narrow, **kw}))
    monkeypatch.setattr(profile_training, "CHAIN", 2)
    monkeypatch.setattr(profile_training, "CHAIN_ITERS", 1)
    out = tmp_path / "training.json"
    records = profile_training.main([
        "--device", "cpu", "--image_size", "32", "--codebook", "16",
        "--batch", "2", "--iters", "1", "--out", str(out)])
    _records_have_the_keys(records, out)
    g, d = records[:2]
    assert g["program"].startswith("g_step (")
    assert d["program"].startswith("d_step (")
    assert g["flops"] > d["flops"] > 0 and g["bytes"] > d["bytes"] > 0
    chains = [r for r in records if " captured " in r["program"]]
    assert [c["flops"] for c in chains] == [2 * g["flops"],
                                            2 * (g["flops"] + d["flops"])]
    assert all(c["flops_true"] == c["flops"] for c in chains)
    programs = [r["program"] for r in records]
    assert any(p.startswith("host dispatch floor") for p in programs)
    assert any(p.startswith("dispatch_step device-only") for p in programs)
    assert len(programs) == 10
    assert profile_training.OUT != REPO / "results" / "training_roofline.json"


def test_profile_sampling_records_on_the_cpu(monkeypatch, tmp_path):
    tiny = dict(dim=16, dim_mults=(1, 2), attn_heads=2, attn_dim_head=16,
                latent_size=4, image_size=32, timesteps=20, num_users=3)
    monkeypatch.setattr(profile_sampling, "LDMConfig",
                        lambda **kw: LDMConfig(**{**tiny, **kw}))
    monkeypatch.setattr(profile_sampling, "KARRAS_STEPS", 2)
    monkeypatch.setattr(profile_sampling, "ITERS", 1)
    out = tmp_path / "sampling.json"
    records = profile_sampling.main([
        "--device", "cpu", "--batch", "2", "--steps", "3", "--out",
        str(out)])
    _records_have_the_keys(records, out)
    (pipe, chain, decode, body, attribution, heun, kfwd,
     k_attribution) = records
    # a chain counts its eager body times its steps, exactly
    assert chain["flops"] == 3 * body["flops"]
    assert pipe["flops"] == chain["flops"] + decode["flops"]
    assert heun["flops"] == 2 * 2 * kfwd["flops"]
    assert attribution["steps"] == 3
    assert k_attribution["program"] == "cfg5 Heun attribution"
    assert profile_sampling.OUT != REPO / "results" / "sampling_roofline.json"

