"""Port parity: data-parallel KL-VAE training (`training/kl_vae_step.py`
on a mesh, `train_kl_vae` under a process group) against the JAX CLI's
mesh.

The JAX side is cli/train_kl_vae.py's step as that CLI runs it: the state
replicated over a mesh of the 8 CPU devices of tests/conftest.py, each
batch placed P("data") (`make_mesh_for_batch`, `replicate`,
`shard_batch`), its loss (`KLVAE.encode`, mean + std * eps,
`KLVAE.decode`, `kl_vae_loss`) and clip + Adam jitted over the global
batch; the small KL-VAE and weights of `test_torch_port_kl_vae.py`, global
batch 8, three steps, the posterior noise eps the same numpy array on
both sides (the two cannot share a random stream). The port runs on 2 and
4 gloo ranks of the CPU (`parallel.launch.spawn`), each on its rows with
the global eps, and in one process (world 1).

- Against JAX: every loss part at each step at LOSS_RTOL, the moves of the
  weights by MOVE_ATOL / MOVE_MISS / MOVE_NORM (Adam's sign-like first
  steps on rounding-noise gradients, `test_torch_port_kl_vae`'s rule).
- Against world 1: the loss parts at SAME_RTOL, the moves by the same rule;
  and with the posterior noise drawn (not given): the global batch's draw
  from one generator, sliced, so the losses equal world 1's drawn ones at
  SAME_RTOL (each rank's own draw would give others).
- Every rank ends with the same logs and weights, bit for bit.
- `train_kl_vae`'s `train` on 2 ranks (the loader's global batches, this
  rank's rows, rank 0's milestones): the losses and weights of the same
  run in one process, by the same rules.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_dist_workers as workers
from test_torch_port_kl_vae import (
    CFG,
    KL_WEIGHT,
    LOSS_RTOL,
    LR,
    MOVE_ATOL,
    MOVE_MISS,
    MOVE_NORM,
    JaxSide,
    write_images,
)
from vqgan_tpu.models import KLVAE as JKLVAE
from vqgan_tpu.models import kl_vae_loss as j_kl_vae_loss
from vqgan_tpu.parallel import make_mesh_for_batch as j_mesh_for_batch
from vqgan_tpu.parallel import replicate as j_replicate
from vqgan_tpu.parallel import shard_batch as j_shard_batch
from vqgan_tpu_torch.checkpoint import CheckpointManager, klvae_state_from_jax
from vqgan_tpu_torch.parallel.launch import spawn

torch.set_num_threads(2)

B, S, STEPS = 8, 32, 3
WORLDS = (2, 4)
SAME_RTOL = 1e-5
SPAWN_TIMEOUT = 300


@pytest.fixture(scope="module")
def runs():
    side = JaxSide()
    rng = np.random.default_rng(12)
    images = rng.random((STEPS, B, S, S, 3)).astype(np.float32)
    eps = rng.standard_normal((STEPS, B, S // 2, S // 2, 4)).astype(
        np.float32)
    vae = side.vae
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR))

    @jax.jit
    def train_step(params, opt_state, images, eps):
        def loss_fn(p):
            posterior = vae.apply(p, images, method=JKLVAE.encode)
            z = posterior.mean + posterior.std * eps
            recon = vae.apply(p, z, method=JKLVAE.decode)
            parts = j_kl_vae_loss(recon, images, posterior,
                                  kl_weight=KL_WEIGHT)
            return parts["loss"], parts

        (_, parts), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, parts

    mesh = j_mesh_for_batch(B)
    params = j_replicate(side.params, mesh)
    opt_state = j_replicate(tx.init(side.params), mesh)
    j_logs = []
    for i in range(STEPS):
        params, opt_state, parts = train_step(
            params, opt_state, j_shard_batch(jnp.asarray(images[i]), mesh),
            j_shard_batch(jnp.asarray(eps[i]), mesh))
        j_logs.append({k: float(v) for k, v in parts.items()})
    init = klvae_state_from_jax(side.params)
    args = (CFG, init, images, eps, KL_WEIGHT, LR, 5)
    drawn = (CFG, init, images, None, KL_WEIGHT, LR, 5)
    port = {1: [workers.kl_vae_steps(0, 1, *args)]}
    port_drawn = {1: [workers.kl_vae_steps(0, 1, *drawn)]}
    for world in WORLDS:
        port[world] = spawn(workers.kl_vae_steps, world, args,
                            timeout=SPAWN_TIMEOUT, threads=2)
        port_drawn[world] = spawn(workers.kl_vae_steps, world, drawn,
                                  timeout=SPAWN_TIMEOUT, threads=2)
    return {"mesh": dict(mesh.shape), "logs": j_logs, "init": init,
            "want": klvae_state_from_jax(jax.tree.map(np.asarray, params)),
            "port": port, "drawn": port_drawn}


def _moves_agree(got, want, init):
    moves = torch.cat([(torch.as_tensor(got[k]) - init[k]).flatten()
                       for k in got])
    want_moves = torch.cat([(torch.as_tensor(want[k]) - init[k]).flatten()
                            for k in got])
    diff = moves - want_moves
    assert want_moves.abs().max() > 0.5 * LR
    assert (diff.abs() > MOVE_ATOL).float().mean() <= MOVE_MISS
    assert diff.norm() <= MOVE_NORM * want_moves.norm()


@pytest.mark.parametrize("world", WORLDS)
def test_steps_on_the_ranks_equal_the_jax_mesh(runs, world):
    assert runs["mesh"]["data"] == 8
    logs, params = runs["port"][world][0]
    for i, (log, want) in enumerate(zip(logs, runs["logs"])):
        for key, value in want.items():
            np.testing.assert_allclose(log[key], value, rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=f"{i} {key}")
    _moves_agree(params, runs["want"], runs["init"])


@pytest.mark.parametrize("which", ["given", "drawn"])
@pytest.mark.parametrize("world", WORLDS)
def test_steps_on_the_ranks_equal_world_one(runs, world, which):
    source = runs["port"] if which == "given" else runs["drawn"]
    one_logs, one_params = source[1][0]
    for logs, params in source[world]:
        for i, (log, ref) in enumerate(zip(logs, one_logs)):
            for key in ref:
                np.testing.assert_allclose(log[key], ref[key],
                                           rtol=SAME_RTOL, atol=1e-7,
                                           err_msg=f"{i} {key}")
        _moves_agree(params, one_params, runs["init"])
    # the drawn noise is not the given one: the draw took part
    if which == "drawn":
        assert one_logs[0]["loss"] != runs["port"][1][0][0][0]["loss"]


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_ends_the_same(runs, world):
    for source in (runs["port"], runs["drawn"]):
        logs, params = source[world][0]
        for other_logs, other_params in source[world][1:]:
            for a, b in zip(logs, other_logs):
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
            for k, v in params.items():
                np.testing.assert_array_equal(other_params[k], v)


def test_train_kl_vae_on_two_ranks_equals_one_process(tmp_path):
    from vqgan_tpu_torch.models.autoencoder import AutoencoderConfig, KLVAE

    split = write_images(tmp_path / "data", users=2, per_user=4)
    small = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=16)

    def argv(name):
        return ["--device", "cpu", "--data_path", str(tmp_path / "data"),
                "--split", str(split), "--results_folder",
                str(tmp_path / name), "--image_size", "16", "--batch_size",
                "4", "--train_steps", "3", "--save_every", "3", "--lr",
                str(LR), "--seed", "3"]

    one = workers.cli_run(0, 1, "train_kl_vae", argv("one"), small)
    two = spawn(workers.cli_run, 2, ("train_kl_vae", argv("two"), small),
                timeout=SPAWN_TIMEOUT, threads=2)
    torch.manual_seed(3)  # the CLI's initial weights
    init = dict(KLVAE(AutoencoderConfig(**small)).named_parameters())
    init = {k: v.detach() for k, v in init.items()}
    for losses, params in two:
        np.testing.assert_allclose(losses, one[0], rtol=SAME_RTOL)
        _moves_agree(params, one[1], init)
    saved = CheckpointManager(tmp_path / "two", prefix="kl_vae")
    assert saved.all_milestones() == [1]
    for k, v in saved.restore()["model"].items():
        if k in two[0][1]:
            np.testing.assert_array_equal(v.numpy(), two[0][1][k])
