"""Port parity: GPipe over the DiT (parallel/pp.py, `dit_pipeline_forward`),
data-parallel serving (`export_serving --dp`) and the multi-device dry run
(`dryrun_multichip`), against the JAX package and the single-device port.

JAX runs on the CPU devices of tests/conftest.py; the port on gloo ranks
of the CPU spawned by `parallel.launch.spawn` (each with a deadline).

- A DiT (dim 32, depth 4, 2 heads x 16, patch 2, 8 x 8 x 4 latents, 5
  classes, fp32; JAX's parameters filled from a numpy seed and carried
  with `dit_state_from_jax`), batch 8 in 2 microbatches: the pipelined
  forward over 2 and 4 stages (and 2 stages x 2 data ranks) against JAX's
  `dit_pipeline_forward` on as many devices and against the port's
  sequential DiT, at JAX's own rule (rtol 2e-4, atol 1e-5); the gradient
  of sum(out^2) for each parameter against the sequential model's
  (each stage holds its own blocks' gradients; the embedding's and the
  head's on every stage) at rtol 1e-4 and atol 1e-4 of the tensor's
  largest gradient (sums over microbatches and stages run in another
  order).
- `pipeline_apply`'s batch rule raises JAX's message; with one stage it is
  the stack run in order.
- `export_serving --dp 2 --selftest` on the CPU (two spawned ranks held to
  the live pipeline on the whole batch), and the dp artifact on two ranks
  against the single-device artifact on the same noise, at the selftest's
  rule (rtol 1e-4, atol 1e-5).
- `dryrun_multichip --n 4` on the CPU: every check runs (none skipped).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import _torch_dist_workers as workers
from vqgan_tpu.models import DiT as JDiT
from vqgan_tpu.models import dit_pipeline_forward as j_pipeline
from vqgan_tpu.parallel.pp import make_pipeline_mesh as j_pipeline_mesh
from vqgan_tpu_torch import dryrun_multichip, export_serving
from vqgan_tpu_torch.checkpoint import CheckpointManager, dit_state_from_jax
from vqgan_tpu_torch.configs import LDMConfig
from vqgan_tpu_torch.models import KLVAE, CFGUnet, DiT
from vqgan_tpu_torch.models.autoencoder import AutoencoderConfig
from vqgan_tpu_torch.parallel import Mesh, pipeline_apply
from vqgan_tpu_torch.parallel.launch import spawn

torch.set_num_threads(2)

DIT = dict(dim=32, depth=4, heads=2, dim_head=16, patch_size=2, image_size=8,
           channels=4, num_classes=5, cond_drop_prob=0.0)
B = 8
SPAWN_TIMEOUT = 180


@pytest.fixture(scope="module")
def dit_case():
    """(JAX variables, port state, numpy inputs x NCHW / t / classes /
    mask, JAX's sequential output NHWC)."""
    module = JDiT(**DIT)
    x0 = jnp.zeros((1, 8, 8, 4))
    i0 = jnp.zeros((1,), jnp.int32)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x0, i0, i0,
                            cond_drop_mask=jnp.zeros((1,), bool))
    rng = np.random.default_rng(0)
    flat = {}
    for path, sds in flatten_dict(shapes).items():
        n = rng.standard_normal(sds.shape).astype(np.float32)
        if path[-1] == "kernel":
            n /= np.sqrt(np.prod(sds.shape[:-1]))
        elif path[-1] == "bias":
            n *= 0.05
        elif path[-1] == "pos_emb":
            n *= 0.1
        flat[path] = n
    variables = unflatten_dict(flat)
    x = rng.standard_normal((B, 8, 8, 4)).astype(np.float32)
    t = rng.integers(0, 20, B).astype(np.int32)
    c = rng.integers(0, 5, B).astype(np.int32)
    mask = rng.random(B) < 0.3
    inputs = (np.ascontiguousarray(x.transpose(0, 3, 1, 2)), t, c, mask)
    return variables, dit_state_from_jax(variables), inputs, (x, t, c, mask)


@pytest.fixture(scope="module")
def sequential(dit_case):
    """The port's sequential DiT: output (NCHW) and parameter gradients."""
    _, state, inputs, _ = dit_case
    dit = DiT(**DIT)
    dit.load_state_dict(state)
    x, t, c, mask = (torch.from_numpy(a) for a in inputs)
    out = dit(x, t.long(), c.long(), cond_drop_mask=mask)
    (out ** 2).sum().backward()
    return out.detach(), {n: p.grad for n, p in dit.named_parameters()}


def _jax_pipelined(dit_case, stages):
    variables, _, _, (x, t, c, mask) = dit_case
    mesh = j_pipeline_mesh(stages=stages, devices=jax.devices()[:stages])
    out = j_pipeline(JDiT(**DIT), variables, jnp.asarray(x), jnp.asarray(t),
                     jnp.asarray(c), mesh, num_microbatches=2,
                     cond_drop_mask=jnp.asarray(mask))
    return np.asarray(out).transpose(0, 3, 1, 2)


CASES = [(2, 2), (4, 4), (4, 2)]  # (world, stages); data = world / stages


@pytest.fixture(scope="module")
def pipelined(dit_case):
    _, state, inputs, _ = dit_case
    return {(w, s): spawn(workers.dit_pipeline, w,
                          (DIT, state, inputs, s), timeout=SPAWN_TIMEOUT)
            for w, s in CASES}


@pytest.mark.parametrize("world,stages", CASES)
def test_pipeline_forward_matches_jax_and_the_sequential_dit(
        dit_case, sequential, pipelined, world, stages):
    ranks = pipelined[(world, stages)]
    out = torch.cat([r[0] for r in ranks[::stages]], 0)
    for r in range(world):  # every stage of a data rank holds the rows
        torch.testing.assert_close(ranks[r][0],
                                   ranks[r - r % stages][0], rtol=0, atol=0)
    np.testing.assert_allclose(out.numpy(), _jax_pipelined(dit_case, stages),
                               rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(out, sequential[0], rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("world,stages", [(2, 2), (4, 4)])
def test_pipeline_gradients_match_the_sequential_dit(sequential, pipelined,
                                                     world, stages):
    per_stage = DIT["depth"] // stages
    for out, grads, stage in pipelined[(world, stages)]:
        for name, want in sequential[1].items():
            if name.startswith("blocks."):
                if int(name.split(".")[1]) // per_stage != stage:
                    continue  # another stage's block
            scale = want.abs().max().item()
            torch.testing.assert_close(grads[name], want, rtol=1e-4,
                                       atol=1e-4 * scale,
                                       msg=lambda m: f"{name}: {m}")


def test_pipeline_apply_keeps_jax_batch_rule():
    mesh = Mesh({"data": 1, "stage": 1}, "cpu")
    stacked = {"w": torch.tensor([2.0, 3.0])}
    x = torch.arange(6.0).reshape(6, 1)
    with pytest.raises(AssertionError,
                       match="batch 6 must divide into 4 microbatches x 1 "
                             "data shards"):
        pipeline_apply(lambda p, h: h * p["w"], stacked, x, mesh,
                       num_microbatches=4)
    y = pipeline_apply(lambda p, h: h * p["w"], stacked, x, mesh,
                       num_microbatches=3)
    torch.testing.assert_close(y, x * 6.0)


@pytest.fixture(scope="module")
def serving_root(tmp_path_factory):
    """An LDM results folder of seeded random weights and a KL-VAE."""
    root = tmp_path_factory.mktemp("serving")
    torch.manual_seed(0)
    config = LDMConfig.from_dict(dict(
        dim=16, dim_mults=[1, 2], attn_heads=2, attn_dim_head=16,
        num_users=3, latent_size=4, image_size=32, timesteps=20,
        sampling_timesteps=3))
    unet = CFGUnet(dim=16, num_classes=3, dim_mults=(1, 2), channels=4,
                   attn_dim_head=16, attn_heads=2)
    CheckpointManager(root / "ldm", prefix="model").save(
        1, {"step": 0, "ema": unet.state_dict()},
        config=dataclasses.asdict(config))
    torch.save(KLVAE(AutoencoderConfig(resolution=32)).state_dict(),
               root / "kl_vae.pt")
    return root


def _export(root, out, *extra):
    return export_serving.main([
        "--checkpoint", str(root / "ldm"), "--vae_path",
        str(root / "kl_vae.pt"), "--out", str(out), "--batch_size", "4",
        "--cond_scale", "3.0", "--device", "cpu", *extra])


def test_export_serving_dp_selftests_on_two_ranks(serving_root, capsys):
    res = _export(serving_root, serving_root / "dp_self", "--dp", "2",
                  "--selftest")
    # the selftest's rule on [0, 1] pixels: |d| <= 1e-5 + 1e-4 |want|
    assert res["selftest"]["max_abs_diff"] <= 1e-5 + 1e-4
    meta = json.loads((serving_root / "dp_self" / "meta.json").read_text())
    assert meta["batch_size"] == 4 and meta["rank_batch_size"] == 2
    assert meta["mesh"] == {"axes": ["data"], "shape": [2], "nr_devices": 2}
    out = capsys.readouterr().out
    assert "data-parallel over 2 ranks" in out and "selftest OK" in out


def test_dp_artifact_equals_the_single_device_artifact(serving_root):
    # the dp artifact of the selftest above (same module, in order)
    from vqgan_tpu_torch.serving import load_cfg_sampler

    _export(serving_root, serving_root / "one")
    g = torch.Generator().manual_seed(3)
    init = torch.randn((4, 4, 4, 4), generator=g)
    steps = torch.randn((3, 4, 4, 4, 4), generator=g)
    classes = np.array([0, 1, 2, 1])
    want = load_cfg_sampler(serving_root / "one", "cpu")(
        torch.from_numpy(classes), init_noise=init, step_noise=steps)
    ranks = spawn(workers.served, 2, (str(serving_root / "dp_self"), classes,
                                      init, steps), timeout=SPAWN_TIMEOUT)
    for got in ranks:
        assert got.shape == (4, 32, 32, 3)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="serves on 2 data-parallel ranks"):
        load_cfg_sampler(serving_root / "dp_self", "cpu",
                         mesh=Mesh({"data": 1}, "cpu"))


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    line = dryrun_multichip.main(["--n", "4", "--device", "cpu"])
    assert line == capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(4): OK loss=")
    for check in ("fsdp=OK", "tp=OK", "pp=OK DiT(depth=8) stages=4",
                  "sp=OK seq=1024 dhead=64 shards=4", "serving=OK dp=2",
                  "zero1=OK", "fsdp_tp=OK"):
        assert check in line, (check, line)
    assert "skipped" not in line
