"""The port against the benchmark's plain reference on the CPU: the
reference's weight names and shapes are the port's modules' at the
published widths; the cells' drivers run end to end at small sizes and
read correct at the cells' own limits; the control (the reference in
float8, in the program's place) reads not correct."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import run
from portbench.faults import CONTROL
from portbench.harness import REPO, ROOT, load_json
from portbench.reference.ldm import klvae_spec, unet_spec
from portbench.reference.vqgan import quantize, vqgan_spec
from portbench.tests.tiny import CELLS, tiny_cell

BENCH = load_json(REPO / "BENCHMARK.json")


def _config(name):
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def _shapes(module):
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def _spec_shapes(spec):
    return {k: tuple(shape) for k, (shape, _) in spec.items()}


def test_vqgan_weights_name_the_port_modules():
    from vqgan_tpu_torch.configs.vqgan_config import VQGANConfig
    from vqgan_tpu_torch.models import LPIPS, VQVAE, PatchGANDiscriminator

    c = VQGANConfig()
    spec = vqgan_spec(_config("vqgan-f8-k128-256px"))
    vq = VQVAE(ch=c.ch, ch_mult=c.ch_mult, num_res_blocks=c.num_res_blocks,
               attn_resolutions=c.attn_resolutions, resolution=c.image_size,
               z_channels=c.z_channels, num_embeddings=c.num_embeddings,
               embedding_dim=c.embedding_dim, out_channels=c.out_channels)
    assert _shapes(vq) == _spec_shapes(spec["vqvae"])
    disc = PatchGANDiscriminator(c.in_channels, c.disc_ndf, c.disc_n_layers,
                                 c.disc_norm)
    assert _shapes(disc) == _spec_shapes(spec["disc"])
    assert _shapes(LPIPS()) == _spec_shapes(spec["lpips"])


def test_ldm_weights_name_the_port_modules():
    from vqgan_tpu_torch.build import build_cfg_unet_diffusion
    from vqgan_tpu_torch.configs.ldm_config import LDMConfig
    from vqgan_tpu_torch.generate import load_vae

    cfg = _config("ldm-cfg-unet-d96")
    model, _ = build_cfg_unet_diffusion(LDMConfig(), device="cpu")
    assert _shapes(model) == _spec_shapes(unet_spec(cfg))
    assert _shapes(load_vae(None, device="cpu")) == \
        _spec_shapes(klvae_spec(cfg))


def _run(capsys, workload, trace=False):
    code = run.execute(tiny_cell(workload, trace=trace), BENCH, device="cpu")
    assert code == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
def test_cell_runs_correct_at_small_size(capsys, workload, trace):
    line = _run(capsys, workload, trace)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    want = {m["name"] for m in run.metrics_for(BENCH, workload, trace)}
    assert set(line["metrics"]) <= want
    if not trace:  # the end-to-end metrics read on any device
        assert set(line["metrics"]) == want
    else:
        assert line["breakdown"]["idle_gaps"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_incorrect_at_small_size(capsys, workload):
    """The reference in float8 (and, for the decode, with TF32 products),
    in the program's place, reads `correct` false by the cell's own
    checks."""
    code = run.execute(tiny_cell(workload), BENCH, device="cpu",
                       fault=CONTROL)
    assert code == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]


def test_quantize_follows_and_judges_the_programs_codes():
    """Given codes, the reference takes them and reads how far z would
    have to move, as a share of |z|, for each to be nearest; rows with no
    code read infinite."""
    codebook = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    z = torch.tensor([[0.6, 0.4], [0.0, 2.0]]).t().reshape(1, 2, 2, 1)
    _, _, own, shift = quantize(z, codebook, 0.25)
    assert own.flatten().tolist() == [0, 1] and shift == 0.0
    forced = torch.tensor([[[1], [1]]])
    zq, _, taken, shift = quantize(z, codebook, 0.25, forced)
    assert taken.flatten().tolist() == [1, 1]
    assert torch.equal(zq[0, :, 0, 0], codebook[1])
    # position 0: the boundary x = y lies 0.2 / sqrt(2) from (0.6, 0.4)
    assert shift == pytest.approx(0.2 / 2 ** 0.5 / (0.52 ** 0.5), rel=1e-5)
    _, _, _, shift = quantize(z, codebook, 0.25, own)
    assert shift == 0.0  # its own codes: no move
    _, _, _, shift = quantize(torch.cat([z, z]), codebook, 0.25, forced)
    assert shift == float("inf")


def test_tiny_configs_change_only_sizes():
    """The tiny cells keep every setting that is not a size."""
    from portbench.tests.tiny import LDM, VQGAN

    sizes = {"image_size", "ch", "ch_mult", "num_res_blocks",
             "attn_resolutions", "z_channels", "num_embeddings",
             "embedding_dim", "disc_ndf", "disc_n_layers", "batch_size",
             "learning_rate", "disc_learning_rate", "compute_dtype", "dim",
             "dim_mults", "attn_heads", "attn_dim_head", "latent_size",
             "train_batch_size", "sampling_timesteps", "train_lr", "vae"}
    assert set(VQGAN) <= sizes and set(LDM) <= sizes
