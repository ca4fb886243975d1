"""Port parity: data-parallel VQ-GAN training (`VQGANTrainer` under a
process group, `training/vqgan_step.py` on a mesh, the global-batch
`BatchNorm` / `ActNorm` of `models/`, `ops/vq.py`'s revival and
`ema_codebook_update`) against the JAX trainer on its mesh.

The JAX side is `VQGANTrainer(use_mesh=True)` on the 8 CPU devices of
tests/conftest.py (its state replicated, each batch placed P("data"), one
jitted program over the global batch), from the weights and the tiny
config of `test_torch_port_vqgan_train.py` (VQ-VAE ch 16, 32 px, codebook
8 x 16; PatchGAN ndf 8, 2 layers, BatchNorm; LPIPS), with the adaptive
weight on and disc_start 1: step 0 G only, steps 1-2 G + D, global batch
8. The port runs on gloo ranks of the CPU (`parallel.launch.spawn`), 2 and
4 of them, each on its rows, in each step mode (split; fused and scan,
whose step bodies run eagerly on the CPU); and in one process with no
group (world 1).

- Against JAX, as `test_torch_port_vqgan_train` holds the split steps:
  every log at LOSS_RTOL (D's logits and accuracy, the VQ losses, the
  adaptive weight at step 1; at step 2 at ADAPTIVE_RTOL), the usage counts equal (the global histogram), the
  BatchNorm running statistics at STATS_ATOL (the global batch's: a
  per-rank statistic is off by ~0.1 here), the moves of the weights by
  MOVE_ATOL / MOVE_MISS / MOVE_NORM.
- Against world 1: the logs at SAME_RTOL, the BatchNorm statistics at
  SAME_ATOL, the moves by the MOVE criteria (the averaged gradient sums in
  another order, and Adam's sign-like first steps turn rounding-noise
  gradients, such as those of conv biases under GroupNorm, into moves of
  lr either way: an element-wise bound on the weights would only hold
  where the arithmetic is the same).
- Every rank ends with the same logs and the same state, bit for bit.
- The revival after three steps: the dead codes those of JAX's global
  usage, the codebook (new rows drawn from every rank's z rows) that of
  world 1 at REVIVED_ATOL.
- `BatchNorm` and `ActNorm` alone on the ranks' rows: the output, the
  running statistics, the gradients and ActNorm's initialisation against
  flax's on the global batch placed P("data") on 8 devices.
- `ema_codebook_update` on the ranks' rows against JAX's on the whole z.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import _torch_dist_workers as workers
from test_torch_port_vqgan_train import (
    LOSS_RTOL,
    LR,
    MOVE_ATOL,
    MOVE_MISS,
    MOVE_NORM,
    STATS_ATOL,
    JaxSide,
)
from vqgan_tpu.configs import VQGANConfig as JVQGANConfig
from vqgan_tpu.models.discriminator import ActNorm as JActNorm
from vqgan_tpu.ops.vq import ema_codebook_update as j_ema_codebook_update
from vqgan_tpu.parallel import make_mesh as j_make_mesh
from vqgan_tpu.parallel import replicate as j_replicate
from vqgan_tpu.training.vqgan_step import VQGANTrainState as JState
from vqgan_tpu.training.vqgan_trainer import VQGANTrainer as JVQGANTrainer
from vqgan_tpu_torch.checkpoint import (
    lpips_state_from_jax,
    patchgan_state_from_jax,
    vqvae_state_from_jax,
)
from vqgan_tpu_torch.parallel.launch import spawn

torch.set_num_threads(2)

B, STEPS = 8, 3
CFG = dict(ch=16, ch_mult=(1, 2), num_res_blocks=1, image_size=32,
           z_channels=16, num_embeddings=8, embedding_dim=16, disc_ndf=8,
           disc_n_layers=2, compute_dtype="float32", batch_size=B,
           disc_start=1, use_adaptive_weight=True)
MODES = ("split", "fused", "scan")
WORLDS = (2, 4)
# the port on its ranks against the port in one process: the same math,
# the sums over the batch in another order
SAME_RTOL = 1e-5
SAME_ATOL = 1e-6
# The adaptive weight from step 2 on: a ratio of the last layer's gradient
# norms, after updates in which Adam's sign-like first steps moved
# rounding-noise elements by lr either way; the port in one process is
# 1.49e-4 from JAX there (measured), the ranks 2.4e-4 from one process at
# most. Step 1's, from step 0's weights, is held at LOSS_RTOL / SAME_RTOL.
ADAPTIVE_RTOL = 5e-4
# The revived codebook rows are z rows of the encoder after three updates,
# whose weights differ between the ranks and one process by those flips
# (measured: 9.9e-6 at most); rows drawn from this rank's z rows alone
# would differ by O(1).
REVIVED_ATOL = 1e-4
SPAWN_TIMEOUT = 300
# the revival's usage threshold: the codes used fewer times than this over
# the three steps are dead (3 of the 8 with these weights and images)
REVIVE_THRESHOLD = 40


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's three steps on its mesh and the port's in every mode at
    worlds 1, 2 and 4 (rank -> mode -> results)."""
    side = JaxSide()  # the weights only; its own steps are never called
    data = np.random.default_rng(11).random(
        (STEPS, B, 32, 32, 3)).astype(np.float32)
    jt = JVQGANTrainer(JVQGANConfig(**CFG, results_folder=str(
        tmp_path_factory.mktemp("jax"))), lpips_params=side.lpips_params,
        use_mesh=True, step_mode="split")
    state = j_replicate(JState(
        step=jnp.asarray(0), vqvae_params=side.vq_params,
        disc_params=side.disc_params, disc_stats=side.disc_stats,
        opt_g=jt.opt_g.init(side.vq_params),
        opt_d=jt.opt_d.init(side.disc_params)), jt.mesh)
    j_logs = []
    for i in range(STEPS):
        state, log = jt.dispatch_step(state, jt._put(jnp.asarray(data[i])),
                                      i)
        j_logs.append(jax.tree.map(np.asarray, log))
    jax_run = {
        "mesh": dict(jt.mesh.shape), "logs": j_logs,
        "vqvae": vqvae_state_from_jax(jax.tree.map(np.asarray,
                                                   state.vqvae_params)),
        "disc": patchgan_state_from_jax(jax.tree.map(
            np.asarray, {**state.disc_params, **state.disc_stats}))}
    init = {"vqvae": vqvae_state_from_jax(side.vq_params),
            "disc": patchgan_state_from_jax({**side.disc_params,
                                             **side.disc_stats}),
            "lpips": lpips_state_from_jax(side.lpips_params)}
    cfg = dict(CFG, revive_dead_codes_every=STEPS,
               revive_usage_threshold=REVIVE_THRESHOLD,
               results_folder=str(tmp_path_factory.mktemp("port")))
    port = {1: [workers.vqgan_modes(0, 1, cfg, init, data, MODES, True)]}
    for world in WORLDS:
        port[world] = spawn(workers.vqgan_modes, world,
                            (cfg, init, data, MODES, True),
                            timeout=SPAWN_TIMEOUT, threads=2)
    return {"jax": jax_run, "init": init, "port": port}


def _moves_agree(got: dict, want: dict, init: dict, label: str):
    """The weights' moves from `init` by the MOVE criteria."""
    moves = torch.cat([(torch.from_numpy(got[k]) - init[k]).flatten()
                       for k in init if "running" not in k])
    want_moves = torch.cat([(torch.as_tensor(want[k]) - init[k]).flatten()
                            for k in init if "running" not in k])
    diff = moves - want_moves
    assert want_moves.abs().max() > 0.5 * LR, label
    assert (diff.abs() > MOVE_ATOL).float().mean() <= MOVE_MISS, label
    assert diff.norm() <= MOVE_NORM * want_moves.norm(), label


def _stats_agree(got: dict, want: dict, atol: float):
    stats = [k for k in want if "running" in k]
    assert stats
    for k in stats:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", WORLDS)
def test_steps_on_the_ranks_equal_the_jax_mesh(runs, world, mode):
    want = runs["jax"]
    assert want["mesh"]["data"] == 8
    got = runs["port"][world][0][mode]
    assert [int(c) for c in got["counts"]] == [STEPS, STEPS - 1]
    for i, (log, j_log) in enumerate(zip(got["logs"], want["logs"])):
        np.testing.assert_array_equal(log["usage_counts"],
                                      j_log["usage_counts"])
        # the captured modes log D's masked step 0 as well
        for key in j_log:
            if key != "usage_counts":
                rtol = (ADAPTIVE_RTOL if key == "disc_weight" and i >= 2
                        else LOSS_RTOL)
                np.testing.assert_allclose(
                    log[key], float(j_log[key]), rtol=rtol, atol=1e-7,
                    err_msg=f"step {i}: {key}")
    assert got["logs"][2]["disc_weight"] != pytest.approx(0.1)
    _stats_agree(got["disc"], want["disc"], STATS_ATOL)
    for part in ("vqvae", "disc"):
        _moves_agree(got[part], want[part], runs["init"][part],
                     f"{mode} {part}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", WORLDS)
def test_steps_on_the_ranks_equal_world_one(runs, world, mode):
    one = runs["port"][1][0][mode]
    got = runs["port"][world][0][mode]
    for i, (log, ref) in enumerate(zip(got["logs"], one["logs"])):
        assert log.keys() == ref.keys()
        np.testing.assert_array_equal(log["usage_counts"],
                                      ref["usage_counts"])
        for key in ref:
            rtol = (ADAPTIVE_RTOL if key == "disc_weight" and i >= 2
                    else SAME_RTOL)
            np.testing.assert_allclose(log[key], ref[key], rtol=rtol,
                                       atol=1e-7, err_msg=f"step {i}: {key}")
    _stats_agree(got["disc"], one["disc"], SAME_ATOL)
    for part in ("vqvae", "disc"):
        init = runs["init"][part]
        _moves_agree(got[part], {k: torch.from_numpy(v)
                                 for k, v in one[part].items()}, init,
                     f"{mode} {part}")


@pytest.mark.parametrize("mode", ["fused", "scan"])
@pytest.mark.parametrize("world", WORLDS)
def test_captured_modes_on_the_ranks_equal_the_split_mode(runs, world, mode):
    """The fused and scan step bodies (eager on the CPU) on the mesh
    against the split steps on the same mesh: the logs of both at
    LOSS_RTOL (SAME_RTOL does not hold: the split steps' `LDMOptimizer`
    and the captured modes' `CapturableOptimizer` form Adam's bias
    corrections in other precisions, and the weights part by Adam's flips
    from step 1 on), the usage counts equal, the statistics at STATS_ATOL,
    the moves by the MOVE criteria."""
    split = runs["port"][world][0]["split"]
    got = runs["port"][world][0][mode]
    for i, (log, ref) in enumerate(zip(got["logs"], split["logs"])):
        np.testing.assert_array_equal(log["usage_counts"],
                                      ref["usage_counts"])
        for key in ref:  # the split step 0 logs no D step
            rtol = (ADAPTIVE_RTOL if key == "disc_weight" and i >= 2
                    else LOSS_RTOL)
            np.testing.assert_allclose(log[key], ref[key], rtol=rtol,
                                       atol=1e-7, err_msg=f"step {i}: {key}")
    _stats_agree(got["disc"], split["disc"], STATS_ATOL)
    for part in ("vqvae", "disc"):
        _moves_agree(got[part], {k: torch.from_numpy(v)
                                 for k, v in split[part].items()},
                     runs["init"][part], f"{mode} {part}")


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_ends_the_same(runs, world):
    first = runs["port"][world][0]
    for other in runs["port"][world][1:]:
        for mode in MODES:
            for part in ("vqvae", "disc"):
                for k, v in first[mode][part].items():
                    np.testing.assert_array_equal(other[mode][part][k], v)
            for a, b in zip(first[mode]["logs"], other[mode]["logs"]):
                for k, v in a.items():
                    np.testing.assert_array_equal(b[k], v)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", WORLDS)
def test_revival_draws_from_the_global_batch(runs, world, mode):
    window = sum(log["usage_counts"] for log in runs["jax"]["logs"])
    dead = window < REVIVE_THRESHOLD
    assert dead.any() and not dead.all(), window
    for ranks in (runs["port"][1], runs["port"][world]):
        n, got_dead, got_window, codebook = ranks[0][mode]["revived"]
        np.testing.assert_array_equal(got_window, window)
        np.testing.assert_array_equal(got_dead, dead)
        assert int(n) == int(dead.sum())
    one = runs["port"][1][0][mode]["revived"][3]
    for rank in runs["port"][world]:
        np.testing.assert_allclose(rank[mode]["revived"][3], one, rtol=0,
                                   atol=REVIVED_ATOL)
    # the revived rows moved away from the stepped codebook
    stepped = runs["port"][1][0][mode]["vqvae"][
        "quantizer.embedding.weight"]
    assert not np.allclose(one[dead], stepped[dead])


def _jax_norms(x, weight, bias, grad_out):
    """flax BatchNorm (the discriminator's: momentum 0.9) in train mode and
    the JAX ActNorm's initialisation, jitted over x placed P("data") on 8
    devices; NHWC inside."""
    mesh = j_make_mesh(data=8, model=1)
    put = NamedSharding(mesh, P("data"))
    xs = jax.device_put(jnp.asarray(x.transpose(0, 2, 3, 1)), put)
    gs = jax.device_put(jnp.asarray(grad_out.transpose(0, 2, 3, 1)), put)
    bn = fnn.BatchNorm(momentum=0.9)
    c = x.shape[1]
    variables = {"params": {"scale": jnp.asarray(weight),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(c), "var": jnp.ones(c)}}

    @jax.jit
    def run(params, xs, gs):
        def loss(p, xs):
            out, upd = bn.apply({"params": p,
                                 "batch_stats": variables["batch_stats"]},
                                xs, use_running_average=False,
                                mutable=["batch_stats"])
            return jnp.sum(out * gs), (out, upd)

        (_, (out, upd)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, xs)
        act = JActNorm()
        avars = act.init(jax.random.PRNGKey(0), xs)
        _, aupd = act.apply(avars, xs, init_actnorm=True,
                            mutable=["actnorm_stats"])
        return out, upd, gp, gx, aupd

    out, upd, gp, gx, aupd = jax.tree.map(np.asarray, run(
        variables["params"], xs, gs))
    stats = aupd["actnorm_stats"]
    return {"out": out.transpose(0, 3, 1, 2),
            "running_mean": upd["batch_stats"]["mean"],
            "running_var": upd["batch_stats"]["var"],
            "weight_grad": gp["scale"], "bias_grad": gp["bias"],
            "x_grad": gx.transpose(0, 3, 1, 2),
            "act_bias": stats["bias"], "act_weight": stats["weight"]}


@pytest.fixture(scope="module")
def norm_inputs():
    rng = np.random.default_rng(5)
    # per-sample offsets, so that each rank's statistics differ from the
    # global batch's
    x = (rng.standard_normal((B, 6, 5, 5)) * 0.7
         + rng.standard_normal((B, 1, 1, 1))).astype(np.float32)
    return (x, (1.0 + 0.1 * rng.standard_normal(6)).astype(np.float32),
            (0.1 * rng.standard_normal(6)).astype(np.float32),
            rng.standard_normal((B, 6, 5, 5)).astype(np.float32))


@pytest.mark.parametrize("world", (1,) + WORLDS)
def test_batchnorm_and_actnorm_take_the_global_batch(norm_inputs, world):
    want = _jax_norms(*norm_inputs)
    if world == 1:
        ranks = [workers.norm_layers(0, 1, *norm_inputs)]
    else:
        ranks = spawn(workers.norm_layers, world, norm_inputs,
                      timeout=SPAWN_TIMEOUT)
    # a rank's own statistics are not the global batch's here
    local = norm_inputs[0][:B // 2].mean(axis=(0, 2, 3))
    assert np.abs(local - norm_inputs[0].mean(axis=(0, 2, 3))).max() > 0.05
    rows = B // world
    for r, got in enumerate(ranks):
        mine = slice(r * rows, (r + 1) * rows)
        np.testing.assert_allclose(got["out"], want["out"][mine],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["x_grad"], want["x_grad"][mine],
                                   rtol=0, atol=1e-5)
        for key in ("running_mean", "running_var", "weight_grad",
                    "bias_grad", "act_bias", "act_weight"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-5, err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
def test_ema_codebook_update_takes_the_global_batch(world):
    rng = np.random.default_rng(9)
    k, d, n = 8, 4, 32
    codebook = rng.standard_normal((k, d)).astype(np.float32)
    size = rng.random(k).astype(np.float32)
    total = rng.standard_normal((k, d)).astype(np.float32)
    z = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(0, k, n).astype(np.int32)
    want = j_ema_codebook_update(*(jnp.asarray(a) for a in
                                   (codebook, size, total, z, idx)))
    ranks = spawn(workers.ema_codebook, world,
                  (codebook, size, total, z, idx), timeout=SPAWN_TIMEOUT)
    for got in ranks:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
