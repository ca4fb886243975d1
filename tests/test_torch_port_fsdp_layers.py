"""FSDP one layer at a time: the sharded LDM step (`parallel/fsdp.py`'s
`ShardedState`, `training/sharded_step.py`) gathers each module's split
parameters just before it runs, keeps no whole parameter from the forward
to the backward, and reduce-scatters each gradient into this rank's piece.

The port runs on gloo ranks of the CPU (`parallel.launch.spawn`, one spawn
per world size, 2 and 4), a small CFG U-Net (dim 16, one level, 2 heads x
16, 8 x 8 x 4 latents, 3 classes, fp32 unless named, FSDP cutoff 256
elements) and a DiT of width 32 and depth 2, global batch 8. Each run is
instrumented (`_torch_dist_workers._layer_run`): the bytes of whole
parameters alive (every tensor `gather_tensor` makes and every cast of
one), sampled as each is made; the same between the forward and the
backward; and each collective's kind and size.

- At most one module's whole parameters are alive at once: the peak is no
  more than the largest module's own (in bf16 compute, its fp32 gather
  and its cast), with the parameters of the modules around it that own
  some (the DiT root's `pos_emb`), as there is no prefetch; and none are
  alive between the forward and the backward, `gradient_checkpointing`
  included (its recomputation, in the backward, holds what it recomputes
  until the backward takes it, so the peak is not bounded there).
- No whole gradient of a split parameter is all-reduced: the elements
  all-reduced in a step are those of the tensors stored whole, the
  pieces of TP's kernels (split over "model" only) and the logs' scalars;
  each reduce-scatter takes one split parameter's whole gradient, once
  per use (the recomputation of `gradient_checkpointing` adds none).
- After a step the model and its EMA copy hold the tensors stored whole
  and nothing of the split ones; every module's parameter slot holds its
  `nn.Parameter` again; and once the trainer is dropped its model is
  freed (what autograd saves stays out of reference cycles, also in a
  branch the loss does not use).
- One step of fsdp, of fsdp with `gradient_checkpointing` and of the DiT
  under fsdp, from JAX's initial weights with JAX's draws, equals JAX's
  fsdp trainer (no remat there: it computes the same) by the rule of
  `test_torch_port_parallel.py`: loss and gradient norm at rtol 1e-4,
  parameters and EMA at atol 0.05 x lr.
- In bf16 compute (the saved tensors are the casts of the gathered
  weights), fsdp equals replicated on the same mesh, in the step mode and
  in the scan mode, two steps each: logs at rtol 2^-7 (two bf16 steps of
  rounding), parameters and EMA at atol 0.05 x lr per step. (Scan against
  step in every mode is `test_torch_port_scan_mesh.py`'s, in fp32.)
- A checkpoint that fsdp writes at world 2 resumes in the replicated
  trainer in one process, bit for bit.
- `comm.reduce_scatter` equals `all_reduce_` and this rank's slice, over
  dims 0 and 1: bit for bit at 2 ranks, at torch's fp32 tolerance at 4
  (the two collectives may add the ranks' terms in other orders); inside
  a capture it refuses gloo.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as workers
from vqgan_tpu.configs import LDMConfig as JLDMConfig
from vqgan_tpu.training.ldm_trainer import LatentDiffusionTrainer as JLDM
from vqgan_tpu_torch.checkpoint import (
    cfg_unet_state_from_jax,
    dit_state_from_jax,
)
from vqgan_tpu_torch.configs import LDMConfig
from vqgan_tpu_torch.parallel.launch import spawn
from vqgan_tpu_torch.training.ldm_trainer import LatentDiffusionTrainer

torch.set_num_threads(2)

LR = 1e-3
MIN_SIZE = 256
B = 8
TINY = dict(dim=16, dim_mults=(1,), attn_heads=2, attn_dim_head=16,
            num_users=3, latent_size=8, image_size=64, timesteps=20,
            sampling_timesteps=3, train_batch_size=B, seed=5,
            compute_dtype="float32", cond_drop_prob=0.0, train_lr=LR,
            save_and_sample_every=1000)
DIT = dict(TINY, model_type="dit", dit_depth=2, dim=8)
BF16 = dict(TINY, compute_dtype="bfloat16", cond_drop_prob=0.5)
SPAWN_TIMEOUT = 300
WORLDS = (2, 4)
LAYERED = ("fsdp", "bf16", "tp", "fsdp_tp", "dit")  # gather per module
ALL = LAYERED + ("zero1", "remat")
AGAINST_JAX = {"fsdp": cfg_unet_state_from_jax,
               "remat": cfg_unet_state_from_jax, "dit": dit_state_from_jax}


def _batch():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((B, 8, 8, 4)).astype(np.float32),
            rng.integers(0, 3, B).astype(np.int64))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """"unet" and "dit": JAX's fsdp trainer, its initial weights, and after
    one step on `_batch()` with its draws the logs, params and EMA."""
    root = tmp_path_factory.mktemp("jax")
    latents, labels = _batch()
    key = jax.random.fold_in(jax.random.PRNGKey(TINY["seed"] + 1), 0)
    k_t, k_p = jax.random.split(key)
    k_noise = jax.random.split(k_p, 3)[0]
    draws = (np.asarray(jax.random.randint(k_t, (B,), 0, TINY["timesteps"])),
             np.asarray(jax.random.normal(k_noise, latents.shape,
                                          jnp.float32)))
    runs = {}
    for name, cfg in (("unet", TINY), ("dit", DIT)):
        j = JLDM(JLDMConfig(**cfg, results_folder=str(root / name)),
                 param_sharding="fsdp", fsdp_min_size=MIN_SIZE)
        init = jax.tree.map(np.asarray, j.state.params)
        state, log = j.train_step(j.state, j._put(jnp.asarray(latents)),
                                  j._put(jnp.asarray(labels)), j._rng)
        runs[name] = {
            "init": init,
            "log": {k: float(v) for k, v in jax.device_get(log).items()},
            "params": jax.tree.map(np.asarray, state.params),
            "ema": jax.tree.map(np.asarray, state.ema_params)}
    return {"runs": runs, "draws": draws}


@pytest.fixture(scope="module")
def port_runs(jax_runs, tmp_path_factory):
    """world -> rank -> run key -> the instrumented run; "folders": world
    -> the runs' results folders."""
    unet = cfg_unet_state_from_jax(jax_runs["runs"]["unet"]["init"])
    dit = dit_state_from_jax(jax_runs["runs"]["dit"]["init"])
    draws = jax_runs["draws"]
    out = {"folders": {}}
    for world in WORLDS:
        root = out["folders"][world] = tmp_path_factory.mktemp(
            f"port{world}")

        def run(key, mode, cfg=TINY, **kw):
            return key, dict(cfg_kwargs=dict(cfg, results_folder=str(
                root / key)), mode=mode, min_size=MIN_SIZE, batch=_batch(),
                **kw)

        runs = [run("fsdp", "fsdp", weights=unet, draws=draws,
                    save=world == 2),
                run("remat", "fsdp", weights=unet, draws=draws,
                    trainer_kwargs=dict(gradient_checkpointing=True)),
                run("dit", "fsdp", DIT, weights=dit, draws=draws),
                run("zero1", "zero1"), run("tp", "tp"),
                run("fsdp_tp", "fsdp_tp"),
                run("bf16", "fsdp", BF16, steps=2)]
        if world == 2:
            runs += [run("bf16_replicated", "replicated", BF16, steps=2),
                     run("bf16_scan", "fsdp", BF16, steps=2,
                         step_mode="scan"),
                     run("bf16_scan_replicated", "replicated", BF16,
                         steps=2, step_mode="scan")]
        scatter = np.random.default_rng(1).standard_normal(
            (world * 2, world * 3, 5)).astype(np.float32)
        out[world] = spawn(workers.layer_by_layer, world, (runs, scatter),
                           timeout=SPAWN_TIMEOUT, threads=1)
    return out


def _all_reduced(run):
    return sum(c[1] for c in run["calls"] if c[0] == "all_reduce")


def _scattered(run):
    return [c[1] for c in run["calls"] if c[0] == "reduce_scatter"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", LAYERED)
def test_at_most_one_modules_parameters_are_whole_at_once(port_runs, world,
                                                          key):
    for rank in port_runs[world]:
        run = rank[key]
        owned = run["owned"]
        # a module's own parameters and those of the modules around it
        bound = max(size + sum(other for name, other in owned.items()
                               if name != o and (
                                   name == "" or o.startswith(name + ".")))
                    for o, size in owned.items())
        assert 0 < run["peak"] <= bound, (run["peak"], bound)
        assert max(owned.values()) < 0.5 * sum(owned.values())
        assert run["between"] == [0] * len(run["logs"])


@pytest.mark.parametrize("world", WORLDS)
def test_no_whole_parameter_lives_from_the_forward_to_the_backward_under_remat(
        port_runs, world):
    for rank in port_runs[world]:
        assert rank["remat"]["between"] == [0]
        assert rank["remat"]["peak"] > 0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", ALL)
def test_no_whole_gradient_of_a_split_parameter_is_all_reduced(port_runs,
                                                               world, key):
    run = port_runs[world][0][key]
    whole, specs = run["whole_numel"], run["specs"]
    grad_specs = {n: specs[n][1] for n in whole}  # the moments' placement
    allowed = sum(whole[n] for n, s in grad_specs.items() if not s)
    allowed += sum(run["pieces"][n] for n, s in grad_specs.items()
                   if s and "data" not in s)
    steps = len(run["logs"])
    assert _all_reduced(run) <= steps * (allowed + 4)  # + the scalars
    # a reduce-scatter takes the whole gradient, less its "model" slice
    model = run["mesh"]["model"]
    scattered = {n: whole[n] // (model if "model" in s else 1)
                 for n, s in grad_specs.items() if "data" in s}
    sizes = sorted(int(np.prod(s)) for s in _scattered(run))
    assert len(sizes) <= len(scattered) * steps
    assert set(sizes) <= set(scattered.values())
    if scattered and run["mesh"]["data"] > 1:
        assert sizes and allowed < 0.5 * sum(whole.values())
    if key == "remat":  # once per use: the recomputation adds none
        assert sizes == sorted(int(np.prod(s)) for s in
                               _scattered(port_runs[world][0]["fsdp"]))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", ALL)
def test_after_a_step_the_model_holds_whole_tensors_and_pieces_only(
        port_runs, world, key):
    for rank in port_runs[world]:
        run = rank[key]
        assert run["all_parameters"]
        for n, (param_spec, opt_spec) in run["specs"].items():
            assert run["held"][n] == (0 if param_spec
                                      else run["whole_numel"][n]), n
            assert run["ema_held"][n] == (0 if opt_spec
                                          else run["whole_numel"][n]), n


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", ALL)
def test_a_dropped_trainer_is_freed(port_runs, world, key):
    for rank in port_runs[world]:
        assert rank[key]["freed"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", sorted(AGAINST_JAX))
def test_fsdp_remat_and_the_dit_equal_jax(jax_runs, port_runs, world, key):
    want = jax_runs["runs"]["dit" if key == "dit" else "unet"]
    ranks = port_runs[world]
    got = ranks[0][key]
    np.testing.assert_allclose(
        [got["logs"][0]["loss"], got["logs"][0]["grad_norm"]],
        [want["log"]["loss"], want["log"]["grad_norm"]], rtol=1e-4)
    for other in ranks[1:]:
        assert other[key]["logs"] == got["logs"]
    for part, tree in (("model", want["params"]), ("ema", want["ema"])):
        ref = AGAINST_JAX[key](tree)
        for name, value in got[part].items():
            torch.testing.assert_close(value, ref[name], rtol=0,
                                       atol=0.05 * LR,
                                       msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("step_mode", ["step", "scan"])
def test_bf16_fsdp_equals_replicated_on_the_mesh(port_runs, step_mode):
    key = "bf16" if step_mode == "step" else "bf16_scan"
    for rank in port_runs[2]:
        got, want = rank[key], rank[key + "_replicated"]
        for a, b in zip(got["logs"], want["logs"]):
            assert a.keys() == b.keys()
            np.testing.assert_allclose([a[k] for k in b], [b[k] for k in b],
                                       rtol=2 ** -7)
        for part in ("model", "ema"):
            for name, value in want[part].items():
                torch.testing.assert_close(
                    got[part][name], value, rtol=0,
                    atol=0.05 * LR * len(want["logs"]),
                    msg=lambda m: f"{part} {name}: {m}")


def test_an_fsdp_checkpoint_of_two_ranks_resumes_in_the_replicated_trainer(
        port_runs):
    sharded = port_runs[2][0]["fsdp"]
    folder = port_runs["folders"][2] / "fsdp"
    plain = LatentDiffusionTrainer(
        LDMConfig(**dict(TINY, results_folder=str(folder))), device="cpu")
    assert plain.placed is None
    assert plain.load(1) == 1
    for name, value in sharded["model"].items():
        assert torch.equal(plain.model.state_dict()[name], value), name
    for name, value in sharded["ema"].items():
        assert torch.equal(plain.ema_model.state_dict()[name], value), name


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("dim", [0, 1])
def test_reduce_scatter_equals_all_reduce_and_slice(port_runs, world, dim):
    for rank in port_runs[world]:
        got, want = rank["scatter"][dim]
        assert got.is_contiguous()
        if world == 2:  # two terms add alike in either order
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want)
    message = port_runs[world][0]["refused"]
    assert message is not None and "gloo" in message and "capture" in message
