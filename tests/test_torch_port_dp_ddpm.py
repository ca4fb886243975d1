"""Port parity: the data-parallel DDPM trainer (`training/ddpm_trainer.py`
`Trainer` under a process group, the global-batch draws of
`parallel.mesh.draw_rows`, the immiscible assignment over the whole batch
in `diffusion/gaussian.py`) against the JAX trainer on its mesh.

The JAX side is `Trainer(use_mesh=True)` of vqgan_tpu/training/
ddpm_trainer.py on the 8 CPU devices of tests/conftest.py (its state
replicated, each batch placed P("data"), one jitted step over the global
batch: the immiscible assignment its `pure_callback` or auction over the
whole batch), with the tiny self-conditioned U-Net of
`test_torch_port_ddpm.py` (dim 8, 8 x 8 x 3 images), global batch 8, two
steps. Its draws come from PRNG keys; the test computes them (t, the
noise, the self-conditioning coin, as `test_torch_port_ddpm` does) and the
port's trainer takes them as the global batch's. The port runs on 2 and 4
gloo ranks of the CPU, each on its rows, and in one process (world 1).

- Self-conditioning with immiscible noise, "host" (scipy's exact
  assignment) and "auction": the losses at LOSS_RTOL against JAX, the
  moves of the weights and of the EMA (the copy of step 0's weights) by
  MOVE_ATOL / MOVE_MISS / MOVE_NORM (Adam's sign-like first steps on
  rounding-noise gradients); against world 1 the losses at SAME_RTOL and
  the moves by the same rule; every rank the same, bit for bit.
- With the draws left to the trainer's generator: the global batch's t,
  noise and coin drawn in the single-device order and sliced, and the
  assignment over the whole batch, so the ranks' losses equal world 1's
  at SAME_RTOL.
- Drawn immiscible noise is drawn whole on every rank: the assignment
  gathers only x_start, given noise is gathered too.
- A milestone with the FID on 2 ranks: each rank samples its share of the
  images and every rank scores their union, as one process scores them.
- `train_ddpm --self_condition --immiscible --save_best_and_latest_only`
  (its bf16 U-Net) on 2 ranks: the losses and weights of the same run in
  one process (the second step's loss at BF16_RTOL); rank 0's "latest"
  milestone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as workers
from test_torch_port_ddpm import DIFF, UNET, random_params
from vqgan_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from vqgan_tpu.models.unet import Unet as JUnet
from vqgan_tpu.training.ddpm_trainer import Trainer as JTrainer
from vqgan_tpu_torch.checkpoint import ddpm_unet_state_from_jax
from vqgan_tpu_torch.eval.fid import FIDStats, frechet_distance
from vqgan_tpu_torch.parallel.launch import spawn

torch.set_num_threads(2)

B, STEPS, SEED = 8, 2, 3
LR = 1e-3
WORLDS = (2, 4)
METHODS = ("host", "auction")
# the loss of one step, fp32 through the U-Net in other summation orders
# (test_torch_port_ddpm holds it at 1e-5; the second step starts from
# weights that differ by the Adam flips below)
LOSS_RTOL = 1e-4
SAME_RTOL = 1e-5
# the moves after two steps: Adam's first steps move each element by about
# lr, one way or the other where its gradient is rounding noise; so the
# moves agree to 5% of lr in all but 1% of the elements and to 5% of the
# move in norm
MOVE_ATOL, MOVE_MISS, MOVE_NORM = 0.05 * LR, 0.01, 0.05
SPAWN_TIMEOUT = 300
# train_ddpm's U-Net computes in bf16 (2^-8 relative rounding)
BF16_RTOL = 1e-2


def jax_draws(step: int):
    """The draws of the JAX trainer's step `step`: its key folded with the
    step, then `loss`'s and `p_losses`' splits."""
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), step)
    k_t, k_p = jax.random.split(key)
    k_noise, _, k_drop = jax.random.split(k_p, 3)
    return {"t": np.asarray(jax.random.randint(k_t, (B,), 0,
                                               DIFF["timesteps"])),
            "noise": np.asarray(jax.random.normal(k_noise, (B, 8, 8, 3),
                                                  jnp.float32)),
            "self_cond_coin": bool(jax.random.uniform(k_drop, ()) < 0.5)}


@pytest.fixture(scope="module", params=METHODS)
def runs(request, tmp_path_factory):
    method = request.param
    jnet = JUnet(**UNET, self_condition=True)
    params = random_params(jnet)
    kw = dict(DIFF, self_condition=True, immiscible=True,
              immiscible_method=method)

    def model_apply(p, x, t, x_self_cond=None, return_features=False):
        return jnet.apply(p, x, t, x_self_cond,
                          return_features=return_features)

    jt = JTrainer(JGaussianDiffusion(model_apply, **kw), params,
                  train_batch_size=B, train_lr=LR, use_mesh=True, seed=SEED,
                  results_folder=str(tmp_path_factory.mktemp("jax")))
    images = np.random.default_rng(13).random(
        (STEPS, B, 8, 8, 3)).astype(np.float32)
    from vqgan_tpu.parallel import shard_batch as j_shard_batch

    state, losses = jt.state, []
    for i in range(STEPS):
        state, loss = jt.train_step(state, j_shard_batch(
            jnp.asarray(images[i]), jt.mesh), jax.random.PRNGKey(SEED))
        losses.append(float(loss))
    draws = [jax_draws(i) for i in range(STEPS)]
    init = ddpm_unet_state_from_jax(params)
    unet = dict(UNET, self_condition=True)
    results = str(tmp_path_factory.mktemp("port"))
    given = (unet, kw, init, images, draws, LR, SEED, results)
    drawn = (unet, kw, init, images, None, LR, SEED, results)
    port = {1: [workers.ddpm_steps(0, 1, *given)]}
    port_drawn = {1: [workers.ddpm_steps(0, 1, *drawn)]}
    for world in WORLDS:
        port[world] = spawn(workers.ddpm_steps, world, given,
                            timeout=SPAWN_TIMEOUT, threads=2)
        port_drawn[world] = spawn(workers.ddpm_steps, world, drawn,
                                  timeout=SPAWN_TIMEOUT, threads=2)
    return {"mesh": dict(jt.mesh.shape), "losses": losses, "init": init,
            "params": ddpm_unet_state_from_jax(jax.tree.map(
                np.asarray, state.params)),
            "ema": ddpm_unet_state_from_jax(jax.tree.map(
                np.asarray, state.ema_params)),
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
    for losses, params, ema in runs["port"][world]:
        np.testing.assert_allclose(losses, runs["losses"], rtol=LOSS_RTOL)
        _moves_agree(params, runs["params"], runs["init"])
        _moves_agree(ema, runs["ema"], runs["init"])


@pytest.mark.parametrize("which", ["given", "drawn"])
@pytest.mark.parametrize("world", WORLDS)
def test_steps_on_the_ranks_equal_world_one(runs, world, which):
    source = runs["port"] if which == "given" else runs["drawn"]
    one_losses, one_params, one_ema = source[1][0]
    first = source[world][0]
    for losses, params, ema in source[world]:
        np.testing.assert_allclose(losses, one_losses, rtol=SAME_RTOL)
        _moves_agree(params, one_params, runs["init"])
        _moves_agree(ema, one_ema, runs["init"])
        assert losses == first[0]
        for k, v in params.items():
            np.testing.assert_array_equal(v, first[1][k])
    if which == "drawn":  # the generator's draws are not JAX's
        assert one_losses[0] != runs["port"][1][0][0][0]


def test_drawn_immiscible_noise_is_not_gathered():
    init = ddpm_unet_state_from_jax(random_params(JUnet(**UNET)))
    images = np.random.default_rng(5).random((4, 8, 8, 3)).astype(
        np.float32)
    kw = dict(DIFF, immiscible=True, immiscible_method="host")
    got = spawn(workers.immiscible_gathers, 2,
                (UNET, kw, init, images, np.array([1, 5, 9, 13])),
                timeout=SPAWN_TIMEOUT, threads=2)
    assert got == [[1, 2], [1, 2]]


def test_fid_milestone_spreads_the_samples_over_the_ranks(tmp_path):
    """10 FID samples in batches of 2: rank 0 samples batches 0, 2 and 4,
    rank 1 batches 1 and 3, each from a generator seeded with its rank
    (rank 0's first batch is one process's first); both score their union
    against the whole set's real statistics, which they also share out."""
    init = ddpm_unet_state_from_jax(random_params(JUnet(**UNET)))
    real = np.random.default_rng(6).random((10, 8, 8, 3)).astype(
        np.float32)
    args = (UNET, DIFF, init, real, 10, 2)
    fid, real_stats, made, saved = workers.ddpm_fid_milestone(
        0, 1, *args, str(tmp_path / "one"))
    two = spawn(workers.ddpm_fid_milestone, 2,
                (*args, str(tmp_path / "two")), timeout=SPAWN_TIMEOUT,
                threads=2)
    assert [len(f) for f in made] == [2] * 5 and saved == [1]
    assert [[len(f) for f in r[2]] for r in two] == [[2] * 3, [2] * 2]
    np.testing.assert_array_equal(two[0][2][0], made[0])
    union = FIDStats(4)
    union.update(np.concatenate(two[0][2] + two[1][2]))
    want = frechet_distance(*real_stats, *union.finalize())
    for got_fid, got_real, _, got_saved in two:
        assert got_fid == two[0][0]
        np.testing.assert_allclose(got_fid, want, rtol=1e-9)
        for g, w in zip(got_real, real_stats):
            np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-14)
        assert got_saved == [1]  # rank 0's, seen by both
    assert fid != two[0][0]  # rank 1 drew other images than batches 1 and 3


def test_train_ddpm_on_two_ranks_equals_one_process(tmp_path):
    from PIL import Image

    from vqgan_tpu_torch.checkpoint import CheckpointManager

    rng = np.random.default_rng(0)
    folder = tmp_path / "images"
    for i in range(8):
        sub = folder / f"ID_{i % 2 + 1}"
        sub.mkdir(parents=True, exist_ok=True)
        Image.fromarray((rng.random((20, 24, 3)) * 255).astype(
            np.uint8)).save(sub / f"{i}.jpg")

    def argv(name):
        return ["--device", "cpu", "--folder", str(folder),
                "--results_folder", str(tmp_path / name), "--image_size",
                "16", "--dim", "8", "--dim_mults", "1", "2", "--timesteps",
                "20", "--sampling_timesteps", "3", "--train_batch_size", "4",
                "--num_samples", "4", "--save_and_sample_every", "2",
                "--train_num_steps", "2", "--self_condition",
                "--immiscible", "--save_best_and_latest_only",
                "--train_lr", str(LR)]

    one = workers.cli_run(0, 1, "train_ddpm", argv("one"))
    two = spawn(workers.cli_run, 2, ("train_ddpm", argv("two")),
                timeout=SPAWN_TIMEOUT, threads=2)
    from vqgan_tpu_torch import train_ddpm

    # the CLI's initial weights, from its seed
    model, _ = train_ddpm.build(train_ddpm.parse_args(argv("init")), "cpu")
    start = {k: v.detach() for k, v in model.named_parameters()}
    for losses, params in two:
        # the first step from the same weights; the second from weights
        # that the bf16 U-Net's rounding and Adam's flips have parted
        np.testing.assert_allclose(losses[0], one[0][0], rtol=SAME_RTOL)
        np.testing.assert_allclose(losses[1:], one[0][1:], rtol=BF16_RTOL)
        _moves_agree(params, one[1], start)
    saved = CheckpointManager(tmp_path / "two", prefix="model")
    assert saved.all_milestones() == [1]  # "latest", from rank 0
    assert saved.restore(1)["step"] == 2
