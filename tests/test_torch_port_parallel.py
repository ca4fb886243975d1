"""Port parity: scale-out of LDM training (vqgan_tpu_torch/parallel/ and
`LatentDiffusionTrainer(param_sharding=...)`) against the JAX package.

The JAX side runs on the 8 CPU devices of tests/conftest.py; the port runs
on gloo ranks of the CPU spawned by `parallel.launch.spawn` (each spawn
with a deadline of its own), at world 2 and 4. A small CFG U-Net (dim 16,
one level, 2 heads x 16, 8 x 8 x 4 latents, 3 classes, fp32: JAX compiles
one step per mode), batch 8, FSDP cutoff 256 elements (so that most tensors
split).

- Placements, tensor by tensor: the port's `state_specs` (parameters,
  Adam moments, EMA) against the shardings of JAX's `LDMTrainer` state
  under each mode, carried into the port's names and layouts through
  `cfg_unet_state_from_jax`.
- One training step under every mode, from JAX's initial weights with
  JAX's draws (t, noise; class dropout off, as JAX's flax RNG stream is
  not replayed): the loss and the gradient norm at rtol 1e-4 and the
  updated parameters and EMA at atol 0.05 x lr (the whole-step rule of
  test_torch_port_train.py) against JAX's trainer with the same mode;
  every rank logs the same numbers; the port's world-2 and world-4 runs
  agree at the same atol (their sums run in other orders).
- The round trip JAX params -> the port's pieces under fsdp_tp at world 4
  -> gathered -> `load_torch_cfg_unet`: bit for bit.
- Each rank's rows of the global batch against JAX's `make_global_array`
  on a (2, 2) mesh, bit for bit.
- The trainer's refusal of an unknown mode; at world 1 every mode is the
  replicated step bit for bit.
- The branches JAX's trainer comparison leaves off, port against port:
  the SupCon loss over the whole batch (every rank's features gathered)
  with the class dropout on, and MultiSteps accumulation (k = 2, the
  clipping norm summed over the ranks' pieces), fsdp at world 2 against
  the single-device trainer, two steps: logs at rtol 1e-5, parameters at
  atol 0.05 x lr.
- `train()` over a cached latent split at world 2 (fsdp): each rank reads
  the global batches through the native latent reader and keeps its rows;
  the losses and parameters equal the single-device trainer's (rtol 1e-5
  / atol 0.05 x lr).
- `train_latent_cfg --param_sharding fsdp_tp` under torchrun (2 CPU
  ranks, gloo from the launcher's environment): its checkpoint after 3
  steps equals the single-process CLI's (atol 0.05 x lr).
- The placement helpers: DTensor placements of a spec, each rank's pieces
  under `apply_fsdp_sharding` / `compose_fsdp_with_tp` /
  `apply_tp_sharding`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dist_workers as workers
from vqgan_tpu.checkpoint.torch_import import load_torch_cfg_unet
from vqgan_tpu.configs import LDMConfig as JLDMConfig
from vqgan_tpu.parallel import make_global_array as j_make_global_array
from vqgan_tpu.parallel import make_mesh as j_make_mesh
from vqgan_tpu.training.ldm_trainer import LatentDiffusionTrainer as JLDM
from vqgan_tpu_torch.build import build_cfg_unet_diffusion
from vqgan_tpu_torch.checkpoint import cfg_unet_state_from_jax
from vqgan_tpu_torch.configs import LDMConfig
from vqgan_tpu_torch.parallel import Mesh, state_specs
from vqgan_tpu_torch.parallel.launch import spawn
from vqgan_tpu_torch.training.ldm_trainer import LatentDiffusionTrainer

torch.set_num_threads(2)

MODES = workers.MODES
LR = 1e-3
MIN_SIZE = 256
B = 8
TINY = dict(dim=16, dim_mults=(1,), attn_heads=2, attn_dim_head=16,
            num_users=3, latent_size=8, image_size=64, timesteps=20,
            sampling_timesteps=3, train_batch_size=B, seed=5,
            compute_dtype="float32", cond_drop_prob=0.0, train_lr=LR,
            save_and_sample_every=1000)
SPAWN_TIMEOUT = 240


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per mode: the JAX trainer's placed state before the step (specs),
    its mesh, and after one step its logs, params and EMA (numpy)."""
    root = tmp_path_factory.mktemp("jax")
    rng = np.random.default_rng(0)
    latents = rng.standard_normal((B, 8, 8, 4)).astype(np.float32)
    labels = rng.integers(0, 3, B).astype(np.int32)
    key = jax.random.fold_in(jax.random.PRNGKey(TINY["seed"] + 1), 0)
    k_t, k_p = jax.random.split(key)
    k_noise = jax.random.split(k_p, 3)[0]
    draws = (np.asarray(jax.random.randint(k_t, (B,), 0, TINY["timesteps"])),
             np.asarray(jax.random.normal(k_noise, latents.shape,
                                          jnp.float32)))
    runs = {}
    for mode in MODES:
        j = JLDM(JLDMConfig(**TINY, results_folder=str(root / mode)),
                 param_sharding=mode, fsdp_min_size=MIN_SIZE)
        specs = jax.tree.map(lambda x: x.sharding.spec, j.state)
        init = jax.tree.map(np.asarray, j.state.params)
        state, log = j.train_step(j.state, j._put(jnp.asarray(latents)),
                                  j._put(jnp.asarray(labels)), j._rng)
        runs[mode] = {
            "mesh": dict(j.mesh.shape), "specs": specs, "init": init,
            "log": {k: float(v) for k, v in jax.device_get(log).items()},
            "params": jax.tree.map(np.asarray, state.params),
            "ema": jax.tree.map(np.asarray, state.ema_params)}
    return {"runs": runs, "batch": (latents, labels), "draws": draws}


@pytest.fixture(scope="module")
def port_runs(jax_runs, tmp_path_factory):
    """world -> rank -> the trainer_modes results (every mode)."""
    init = cfg_unet_state_from_jax(jax_runs["runs"]["replicated"]["init"])
    out = {}
    for world in (2, 4):
        cfg = dict(TINY, results_folder=str(
            tmp_path_factory.mktemp(f"port{world}")))
        out[world] = spawn(workers.trainer_modes, world,
                           (cfg, init, jax_runs["batch"], jax_runs["draws"],
                            MIN_SIZE), timeout=SPAWN_TIMEOUT, threads=2)
    return out


def _opt_mu(opt_state):
    if hasattr(opt_state, "mu"):
        return opt_state.mu
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _opt_mu(s)
            if found is not None:
                return found
    return None


def _port_specs_of(jax_specs, shapes_tree):
    """JAX PartitionSpecs of the CFG U-Net tree -> name -> the port's
    placement, by carrying an index pattern per mesh axis through
    `cfg_unet_state_from_jax` and reading which torch dimension it
    varies along."""
    flat_specs = jax.tree_util.tree_flatten_with_path(
        jax_specs, is_leaf=lambda x: isinstance(x, P))[0]
    flat_shapes = dict(jax.tree_util.tree_flatten_with_path(shapes_tree)[0])
    out = {}
    for axis in ("data", "model"):
        def pattern(path, spec):
            shape = flat_shapes[path].shape
            arr = np.zeros(shape, np.float32)
            dims = [d for d, a in enumerate(tuple(spec)) if a == axis]
            if dims:
                d = dims[0]
                idx = [None] * len(shape)
                idx[d] = slice(None)
                arr = arr + np.arange(shape[d], dtype=np.float32)[
                    tuple(idx)]
            return arr

        tree = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(shapes_tree),
            [pattern(path, spec) for path, spec in flat_specs])
        for name, t in cfg_unet_state_from_jax(tree).items():
            spec = list(out.get(name, [None] * t.ndim))
            for d in range(t.ndim):
                if t.shape[d] > 1 and bool((t.diff(dim=d) != 0).any()):
                    spec[d] = axis
            out[name] = spec
    return {k: tuple(v) if any(a is not None for a in v) else ()
            for k, v in out.items()}


@pytest.mark.parametrize("mode", MODES)
def test_placements_equal_jax_tensor_by_tensor(jax_runs, mode):
    run = jax_runs["runs"][mode]
    model, _ = build_cfg_unet_diffusion(LDMConfig(**TINY), device="cpu")
    got = state_specs(model, Mesh(run["mesh"], "cpu"), mode, MIN_SIZE)
    params = run["init"]
    want = {
        "params": _port_specs_of(run["specs"].params, params),
        "ema": _port_specs_of(run["specs"].ema_params, params),
        "opt": _port_specs_of(_opt_mu(run["specs"].opt_state), params)}
    for part in ("params", "opt", "ema"):
        for name, spec in want[part].items():
            assert got[part][name] == spec, (part, name)
    n_split = sum(bool(s) for s in got["opt"].values())
    assert (n_split == 0) if mode == "replicated" else n_split > 10, n_split


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_one_step_of_every_mode_equals_jax(jax_runs, port_runs, world, mode):
    want = jax_runs["runs"][mode]
    ranks = port_runs[world]
    got = ranks[0][mode]
    tp_model = 2 if "tp" in mode else 1
    assert got["mesh"] == {"data": world // tp_model, "model": tp_model}
    np.testing.assert_allclose(
        [got["log"]["loss"], got["log"]["grad_norm"]],
        [want["log"]["loss"], want["log"]["grad_norm"]], rtol=1e-4)
    for other in ranks[1:]:
        assert other[mode]["log"] == got["log"]
    for part, tree in (("model", want["params"]), ("ema", want["ema"])):
        ref = cfg_unet_state_from_jax(tree)
        for name, value in got[part].items():
            torch.testing.assert_close(value, ref[name], rtol=0,
                                       atol=0.05 * LR,
                                       msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("mode", MODES)
def test_world_two_and_four_agree(port_runs, mode):
    a, b = port_runs[2][0][mode], port_runs[4][0][mode]
    for part in ("model", "ema"):
        for name in a[part]:
            torch.testing.assert_close(a[part][name], b[part][name],
                                       rtol=0, atol=0.05 * LR)


def test_pieces_are_smaller_than_the_whole_under_fsdp(port_runs):
    whole = port_runs[4][0]["replicated"]["pieces"]
    for mode in ("zero1", "fsdp", "fsdp_tp"):
        pieces = port_runs[4][0][mode]["pieces"]
        assert sum(np.prod(s) for s in pieces.values()) < 0.6 * sum(
            np.prod(s) for s in whole.values()), mode


def test_weights_round_trip_through_the_sharded_port(jax_runs, port_runs):
    init = jax_runs["runs"]["replicated"]["init"]
    for world in (2, 4):
        gathered = workers.numpy_tree(port_runs[world][0]["fsdp_tp"]["before"])
        back = load_torch_cfg_unet(gathered)
        flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
        flat_init = dict(jax.tree_util.tree_flatten_with_path(init)[0])
        assert len(flat_back) == len(flat_init)
        for path, value in flat_back:
            np.testing.assert_array_equal(np.asarray(value), flat_init[path],
                                          err_msg=str(path))


def test_rows_of_the_global_batch_equal_make_global_array():
    batch = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    mesh = j_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    arr = j_make_global_array(batch, mesh)
    by_device = {s.device: np.asarray(s.data)
                 for s in arr.addressable_shards}
    devices = mesh.devices  # [data, model]
    ranks = spawn(workers.batch_rows, 4, (batch,), timeout=SPAWN_TIMEOUT)
    for rank, (rows, placed, (d, m)) in enumerate(ranks):
        assert (d, m) == divmod(rank, 2)
        np.testing.assert_array_equal(rows.numpy(), by_device[devices[d, m]])
        np.testing.assert_array_equal(placed.numpy(), rows.numpy())


def _tiny_trainer(tmp_path, mode, **kw):
    cfg = LDMConfig(**dict(TINY, results_folder=str(tmp_path / mode),
                           cond_drop_prob=0.5))
    return LatentDiffusionTrainer(cfg, device="cpu", param_sharding=mode,
                                  fsdp_min_size=MIN_SIZE, **kw)


def test_world_one_modes_are_the_replicated_step_bit_for_bit(tmp_path):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((B, 8, 8, 4)).astype(np.float32))
    c = torch.from_numpy(rng.integers(0, 3, B)).long()
    results = {}
    for mode in MODES:
        tr = _tiny_trainer(tmp_path, mode)
        assert (tr.placed is None) == (mode == "replicated")
        logs = [tr.train_step(tr.state, x, c, generator=tr.generator)
                for _ in range(2)]
        state = (tr.placed.state_dict() if tr.placed is not None
                 else tr.state.state_dict())
        results[mode] = ([{k: float(v) for k, v in g.items()} for g in logs],
                         state)
    base_logs, base = results["replicated"]
    for mode, (logs, state) in results.items():
        assert logs == base_logs, mode
        for part in ("model", "ema"):
            for name, value in base[part].items():
                assert torch.equal(value, state[part][name]), (mode, name)


def test_sharded_checkpoint_resumes_in_the_replicated_trainer(tmp_path):
    tr = _tiny_trainer(tmp_path, "fsdp_tp")
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((B, 8, 8, 4)).astype(np.float32))
    c = torch.from_numpy(rng.integers(0, 3, B)).long()
    tr.train_step(tr.state, x, c, generator=tr.generator)
    tr.save_and_sample(1)
    plain = _tiny_trainer(tmp_path, "replicated")
    plain.config.results_folder = tr.config.results_folder
    plain.ckpt = tr.ckpt
    assert plain.load(1) == 1
    for name, value in tr.placed.gathered("model").items():
        assert torch.equal(plain.model.state_dict()[name], value), name
    for name, value in tr.placed.gathered("ema").items():
        assert torch.equal(plain.ema_model.state_dict()[name], value), name


def test_the_trainer_refuses_what_it_cannot_run(tmp_path):
    with pytest.raises(AssertionError):
        _tiny_trainer(tmp_path, "zero3")
    # the captured step mode runs on a mesh: test_torch_port_scan_mesh.py
    # holds it to the step mode there
    assert _tiny_trainer(tmp_path, "fsdp", step_mode="scan").placed


def test_the_cli_takes_the_jax_flag():
    from vqgan_tpu_torch.train_latent_cfg import parse_args

    assert parse_args([]).param_sharding == "replicated"
    for mode in MODES:
        assert parse_args(["--param_sharding", mode]).param_sharding == mode
    with pytest.raises(SystemExit):
        parse_args(["--param_sharding", "zero3"])


@pytest.mark.parametrize("variant", ["contrastive", "accumulate"])
def test_sharded_branches_equal_the_single_device_trainer(tmp_path,
                                                          variant):
    extra = (dict(use_contrastive_loss=True, contrastive_weight=0.5,
                  contrastive_start_step=0, cond_drop_prob=0.5)
             if variant == "contrastive"
             else dict(gradient_accumulate_every=2, max_grad_norm=0.05))
    cfg = dict(TINY, **extra, results_folder=str(tmp_path / "w"))
    rng = np.random.default_rng(6)
    batches = [(rng.standard_normal((B, 8, 8, 4)).astype(np.float32),
                rng.integers(0, 3, B).astype(np.int64)) for _ in range(2)]
    ranks = spawn(workers.variant_steps, 2, (cfg, "fsdp", batches,
                                             MIN_SIZE),
                  timeout=SPAWN_TIMEOUT, threads=2)
    want_logs, want = _single(cfg, tmp_path, batches)
    for logs, params in ranks:
        for got, ref in zip(logs, want_logs):
            assert got.keys() == ref.keys()
            np.testing.assert_allclose([got[k] for k in ref],
                                       [ref[k] for k in ref], rtol=1e-5)
        for name, value in params.items():
            torch.testing.assert_close(value, want[name], rtol=0,
                                       atol=0.05 * LR,
                                       msg=lambda m: f"{name}: {m}")


def _single(cfg, tmp_path, batches):
    """The single-device trainer (no mesh) on the whole batches."""
    tr = LatentDiffusionTrainer(LDMConfig(**dict(
        cfg, results_folder=str(tmp_path / "one"))), device="cpu")
    assert tr.placed is None
    logs = []
    for latents, labels in batches:
        log = tr.train_step(tr.state, torch.from_numpy(latents),
                            torch.from_numpy(labels), generator=tr.generator)
        logs.append({k: float(v) for k, v in log.items()})
    return logs, {k: v.detach() for k, v in tr.model.named_parameters()}


def test_placement_helpers():
    from torch.distributed.tensor import Replicate, Shard

    from vqgan_tpu_torch.parallel import (
        apply_fsdp_sharding,
        apply_tp_sharding,
        compose_fsdp_with_tp,
    )
    from vqgan_tpu_torch.parallel.mesh import placements

    mesh = Mesh({"data": 4, "model": 2}, "cpu")
    assert placements((None, "data", "model", None), mesh) == [Shard(1),
                                                               Shard(2)]
    assert placements((), mesh) == [Replicate(), Replicate()]
    model, _ = build_cfg_unet_diffusion(LDMConfig(**TINY), device="cpu")
    whole = dict(model.named_parameters())
    for mode, pieces in (
            ("fsdp", apply_fsdp_sharding(model, mesh, min_size=MIN_SIZE)),
            ("fsdp_tp", compose_fsdp_with_tp(model, mesh,
                                             min_size=MIN_SIZE)),
            ("tp", apply_tp_sharding(model, mesh))):
        specs = state_specs(model, mesh, mode,
                            MIN_SIZE if "fsdp" in mode else 2 ** 14)["params"]
        for name, piece in pieces.items():
            want = whole[name].detach()
            for d, axis in enumerate(specs[name]):
                if axis is not None:  # this process is rank 0 of each axis
                    want = want.chunk(mesh.shape[axis], dim=d)[0]
            assert torch.equal(piece, want), (mode, name)
        assert any(specs.values()), mode


def test_train_reads_each_ranks_rows_of_the_global_batches(tmp_path):
    from vqgan_tpu_torch.data import LatentCache, save_split

    rng = np.random.default_rng(7)
    cache = LatentCache(tmp_path / "cache")
    split = {"metadata": {}, "users": {}}
    for user in (1, 2, 3):
        names = [f"frame_{i:03d}.png" for i in range(6)]
        split["users"][f"ID_{user}"] = {"train_images": names,
                                        "test_images": []}
        for name in names:
            cache.save(user - 1, name,
                       rng.standard_normal((8, 8, 4)).astype(np.float32))
    save_split(split, tmp_path / "split.json")
    cfg = dict(TINY, latents_cache_folder=str(tmp_path / "cache"),
               images_per_user_train=6, cond_drop_prob=0.5)
    one = workers.train_run(0, 1, dict(cfg, results_folder=str(
        tmp_path / "one")), str(tmp_path / "split.json"), "replicated", 3)
    ranks = spawn(workers.train_run, 2, (dict(cfg, results_folder=str(
        tmp_path / "two")), str(tmp_path / "split.json"), "fsdp", 3),
        timeout=SPAWN_TIMEOUT, threads=2)
    assert one[1] == "native_latents"
    for losses, loader, params in ranks:
        assert loader == "native_latents" and len(losses) == 3
        np.testing.assert_allclose(losses, one[0], rtol=1e-5)
        for name, value in params.items():
            torch.testing.assert_close(value, one[2][name], rtol=0,
                                       atol=0.05 * LR,
                                       msg=lambda m: f"{name}: {m}")


def test_train_latent_cfg_under_torchrun_equals_one_process(tmp_path):
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from vqgan_tpu_torch.checkpoint import CheckpointManager
    from vqgan_tpu_torch.data import LatentCache, save_split
    from vqgan_tpu_torch.parallel.launch import free_port

    rng = np.random.default_rng(8)
    cache = LatentCache(tmp_path / "cache")
    split = {"metadata": {}, "users": {}}
    for user in (1, 2, 3):
        names = [f"frame_{i:03d}.png" for i in range(6)]
        split["users"][f"ID_{user}"] = {"train_images": names,
                                        "test_images": []}
        for name in names:
            cache.save(user - 1, name,
                       rng.standard_normal((8, 8, 4)).astype(np.float32))
    save_split(split, tmp_path / "split.json")
    config = {k: v for k, v in TINY.items() if k != "train_batch_size"}
    (tmp_path / "tiny.json").write_text(json.dumps(dict(
        config, dim_mults=[1], images_per_user_train=6)))
    args = ["-m", "vqgan_tpu_torch.train_latent_cfg", "--device", "cpu",
            "--config", str(tmp_path / "tiny.json"), "--split",
            str(tmp_path / "split.json"), "--latents_cache_folder",
            str(tmp_path / "cache"), "--train_batch_size", "4",
            "--train_num_steps", "3"]
    repo = Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": str(repo), "OMP_NUM_THREADS": "1"}
    saved = {}
    for name, launcher, mode in (
            ("one", [], "replicated"),
            ("two", ["-m", "torch.distributed.run", "--nproc_per_node", "2",
                     "--master_port", str(free_port())], "fsdp_tp")):
        proc = subprocess.run(
            [sys.executable, *launcher, *args, "--results_folder",
             str(tmp_path / name), "--param_sharding", mode],
            capture_output=True, text=True, timeout=240, cwd=repo, env=env)
        assert proc.returncode == 0, proc.stderr[-3000:]
        saved[name] = CheckpointManager(tmp_path / name,
                                        prefix="model").restore()
    assert saved["two"]["step"] == saved["one"]["step"] == 3
    for part in ("model", "ema"):
        for key, value in saved["one"][part].items():
            torch.testing.assert_close(saved["two"][part][key], value,
                                       rtol=0, atol=0.05 * LR,
                                       msg=lambda m: f"{part} {key}: {m}")
