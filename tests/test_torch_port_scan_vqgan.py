"""Port parity: the VQ-GAN's captured step modes (`make_vqgan_train_step`,
`make_vqgan_scan_steps`, the trainer's "fused" and "scan" modes and
`train_vqgan --step_mode`) against the JAX package, on the CPU.

The tiny config and the weights of `test_torch_port_vqgan_train.py` (VQ-VAE
ch 16, 32 px, codebook 8 x 16; PatchGAN ndf 8, 2 layers, BatchNorm; LPIPS),
carried into the port with `checkpoint/from_jax.py`. The VQ-GAN step draws
no noise, so the comparison is with JAX's own scan programs (its VQ as the
JAX tests take it on the CPU).

- A block of 3 against JAX's `make_vqgan_scan_steps`, at (start,
  disc_start) (4, 0), (0, 100) and (2, 4) as `tests/test_scan_step.py`
  does, and the fused step against JAX's `make_vqgan_train_step` over
  `test_torch_port_vqgan_train`'s three steps across disc_start: held to
  JAX as that file holds the split steps (every log, the usage counts,
  the weights' moves and the BatchNorm statistics); the discriminator
  untouched while frozen; and against the port's own split steps on the
  same data (logs, weights and statistics; the tolerances below).
- `scan_g` equal to `scan_gd` before disc_start, which leaves D, its
  statistics and `opt_d` bit for bit as they were.
- `train_vqgan --step_mode scan`: the event rule (blocks, single steps
  before each log, revival and save), losses equal to split mode's,
  resume, the revival cadence; the non-finite drain; `auto`.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.models.lpips import perceptual_loss_fn as j_perceptual_fn
from vqgan_tpu.training.vqgan_step import (
    make_vqgan_scan_steps as j_scan_steps,
)
from vqgan_tpu.training.vqgan_step import (
    make_vqgan_train_step as j_train_step,
)
from vqgan_tpu_torch.checkpoint import (
    CheckpointManager,
    lpips_state_from_jax,
    patchgan_state_from_jax,
    vqvae_state_from_jax,
)
from vqgan_tpu_torch.models import LPIPS, VQVAE, PatchGANDiscriminator
from vqgan_tpu_torch.models.lpips import perceptual_loss_fn
from vqgan_tpu_torch.training import (
    VQGANTrainState,
    make_gan_optimizers,
    make_vqgan_scan_steps,
    make_vqgan_split_steps,
    make_vqgan_train_step,
)
from vqgan_tpu_torch.training.watchdog import TrainingDiverged

from test_torch_port_vqgan_train import (
    DISC,
    LOSS_RTOL,
    LR,
    MOVE_ATOL,
    MOVE_MISS,
    MOVE_NORM,
    STATS_ATOL,
    VQ,
    JaxSide,
    batches,
    write_image_folder,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


# JAX's step counter does nothing in a VQ-GAN step but gate D (step >=
# disc_start), so one pair of JAX scan programs, built at J_DISC_START,
# serves every (start, disc_start) case with its counter shifted by
# J_DISC_START - disc_start: two compiles where each case would take one.
J_DISC_START = 4


@pytest.fixture(scope="module")
def side():
    return JaxSide()


@pytest.fixture(scope="module")
def j_scans(side):
    return j_scan_steps(*jax_applies(side), side.opt_g, side.opt_d,
                        **jax_kwargs(side, J_DISC_START))


def jax_applies(side):
    def vqvae_apply(params, images):
        return side.vqvae.apply(params, images)

    def disc_apply(params, stats, images, train):
        if train:
            logits, upd = side.disc.apply({**params, **stats}, images,
                                          train=True,
                                          mutable=["batch_stats"])
            return logits, {"batch_stats": upd["batch_stats"]}
        return side.disc.apply({**params, **stats}, images,
                               train=False), stats

    return vqvae_apply, disc_apply


def jax_kwargs(side, disc_start):
    return dict(disc_start=disc_start, donate=False,
                perceptual_fn=j_perceptual_fn(side.lpips_params, side.lpips))


def port_state(side, step=0, capturable=True):
    vqvae = VQVAE(**VQ)
    vqvae.load_state_dict(vqvae_state_from_jax(side.vq_params))
    disc = PatchGANDiscriminator(**DISC)
    disc.load_state_dict(patchgan_state_from_jax(
        {**side.disc_params, **side.disc_stats}))
    lpips = LPIPS()
    lpips.load_state_dict(lpips_state_from_jax(side.lpips_params))
    lpips.eval().requires_grad_(False)
    opt_g, opt_d = make_gan_optimizers(
        vqvae.parameters(), disc.parameters(), learning_rate=LR,
        disc_learning_rate=LR, capturable=capturable)
    return (VQGANTrainState(step, vqvae, disc, opt_g, opt_d),
            perceptual_loss_fn(lpips))


# Tolerances. Against JAX, as `test_torch_port_vqgan_train` holds the
# port's split steps: every log at LOSS_RTOL at every step, the usage
# counts equal, the weights' moves from the shared start and the BatchNorm
# statistics by its MOVE_ATOL / MOVE_MISS / MOVE_NORM / STATS_ATOL.
#
# Against the port's own split steps on the same data, over the same
# optimizer (`CapturableOptimizer`), in one process: the same kernels in
# the same order, the D update masked by `torch.where` and the device gate
# adding exact zeros, so the logs agree to SAME_RTOL and the weights and
# statistics to SAME_ATOL. Over `LDMOptimizer`, whose bias corrections
# round otherwise, the weights part by Adam's sign-like first steps on
# rounding-noise gradients (conv biases under GroupNorm move by lr one way
# or the other): that pair is held to JAX above, not to each other.
SAME_RTOL = 1e-5
SAME_ATOL = 1e-6


def assert_logs_match(logs, want_logs, n, same=False):
    """Stacked logs [n] against JAX's at LOSS_RTOL, the usage counts equal;
    with `same` (against the port's split steps) at SAME_RTOL."""
    assert set(logs) == set(want_logs)
    for key, value in logs.items():
        want = np.asarray(want_logs[key])
        assert value.shape[0] == n and want.shape[0] == n, key
        if key == "usage_counts" and not same:
            np.testing.assert_array_equal(value.numpy(), want, err_msg=key)
            continue
        np.testing.assert_allclose(value.numpy(), want,
                                   rtol=SAME_RTOL if same else LOSS_RTOL,
                                   atol=1e-7, err_msg=key)


def assert_same_state(state, other):
    """The port's steps against its split steps: weights, BatchNorm
    statistics and both optimizers' counts."""
    for module, ref in ((state.vqvae, other.vqvae),
                        (state.disc, other.disc)):
        for (name, a), b in zip(module.state_dict().items(),
                                ref.state_dict().values()):
            torch.testing.assert_close(a, b, rtol=0, atol=SAME_ATOL,
                                       msg=name)
    for opt, ref in ((state.opt_g, other.opt_g), (state.opt_d, other.opt_d)):
        assert opt.state_dict()["count"] == ref.state_dict()["count"]


def assert_moves_match_jax(state, j_state, side, disc_updates: int):
    """The weights' moves from the shared start and the BatchNorm
    statistics against JAX's, by `test_torch_port_vqgan_train`'s criteria:
    the moves agree to MOVE_ATOL in all but MOVE_MISS of the elements and
    to MOVE_NORM of the move in norm, the statistics to STATS_ATOL. A
    missed update, or one of the wrong size, is off in every element.

    The norm check is left out for a discriminator that took one update:
    Adam's first step moves each element by lr one way or the other, so
    each element whose gradient rounds to the other sign adds 2 lr to the
    difference. Measured at (start, disc_start) (2, 4): 0.17% of D's
    elements (about 20 of 11,400) off, 8.4% of the move in norm."""
    checks = (
        ("vqvae", 2, state.vqvae, vqvae_state_from_jax(
            jax.tree.map(np.asarray, j_state.vqvae_params)),
         vqvae_state_from_jax(side.vq_params)),
        ("disc", disc_updates, state.disc, patchgan_state_from_jax(
            jax.tree.map(np.asarray, {**j_state.disc_params,
                                      **j_state.disc_stats})),
         patchgan_state_from_jax({**side.disc_params, **side.disc_stats})),
    )
    for label, updates, module, want, init in checks:
        moves, want_moves = [], []
        for name, value in module.state_dict().items():
            if "running" in name:  # BatchNorm statistics: no Adam in them
                torch.testing.assert_close(value, want[name], rtol=0,
                                           atol=STATS_ATOL, msg=name)
            else:
                moves.append((value - init[name]).flatten())
                want_moves.append((want[name] - init[name]).flatten())
        moves, want_moves = torch.cat(moves), torch.cat(want_moves)
        diff = moves - want_moves
        assert (want_moves.abs().max() > 0.5 * LR) == (updates > 0), label
        assert (diff.abs() > MOVE_ATOL).float().mean() <= MOVE_MISS, label
        if updates > 1:
            assert diff.norm() <= MOVE_NORM * want_moves.norm(), label


def assert_frozen_disc(state, j_state, side):
    """D, its statistics and opt_d as they were, on both sides."""
    init = patchgan_state_from_jax({**side.disc_params, **side.disc_stats})
    want = patchgan_state_from_jax(jax.tree.map(
        np.asarray, {**j_state.disc_params, **j_state.disc_stats}))
    for name, value in state.disc.state_dict().items():
        assert torch.equal(value, init[name]), name
        assert torch.equal(want[name], init[name]), name
    assert state.opt_d.state_dict()["count"] == 0


@pytest.mark.parametrize("start,disc_start", [
    (4, 0),    # D active at every step of the block
    (0, 100),  # D frozen at every step: the G-only scan
    (2, 4),    # the block straddles disc_start: steps 2, 3 frozen, 4 not
])
def test_scan_block_matches_the_jax_scan(side, j_scans, start, disc_start):
    block = 3
    data = batches(block, seed=7)
    j_gd, j_g = j_scans
    g_only = start + block <= disc_start
    j_start = start - disc_start + J_DISC_START
    j_state = side.state().replace(step=jnp.asarray(j_start))
    j_state, j_logs = (j_g if g_only else j_gd)(j_state, jnp.asarray(data))

    state, perceptual = port_state(side, step=start)
    scan_gd, scan_g = make_vqgan_scan_steps(disc_start=disc_start,
                                            perceptual_fn=perceptual)
    logs = (scan_g if g_only else scan_gd)(state, torch.from_numpy(data))
    assert state.step == start + block
    assert int(j_state.step) == j_start + block
    assert_logs_match(logs, j_logs, block)
    updates_d = max(0, start + block - max(start, disc_start))
    assert_moves_match_jax(state, j_state, side, disc_updates=updates_d)
    if not updates_d:
        assert_frozen_disc(state, j_state, side)
    assert state.opt_d.state_dict()["count"] == updates_d
    assert state.opt_g.state_dict()["count"] == block

    # the port's own split steps on the same data
    split, perceptual = port_state(side, step=start)
    g_step, d_step = make_vqgan_split_steps(disc_start=disc_start,
                                            perceptual_fn=perceptual)
    split_logs = []
    for i in range(block):
        x = torch.from_numpy(data[i])
        recon, log = g_step(split, x)
        if start + i >= disc_start:
            log.update(d_step(split, x, recon))
        split_logs.append(log)
    # the split steps log no D loss where they run no D step
    assert_logs_match({k: v for k, v in logs.items() if k in split_logs[-1]},
                      {k: torch.stack([log.get(k, logs[k][i])
                                       for i, log in enumerate(split_logs)])
                       for k in split_logs[-1]}, block, same=True)
    assert_same_state(state, split)


def test_fused_step_matches_the_jax_fused_step(side):
    # test_torch_port_vqgan_train's three steps and data: disc_start 1, so
    # step 0's D update is masked and steps 1 and 2 take theirs
    data = batches()
    split, split_perceptual = port_state(side)
    g_step, d_step = make_vqgan_split_steps(disc_start=1,
                                            perceptual_fn=split_perceptual)
    j_step = j_train_step(*jax_applies(side), side.opt_g, side.opt_d,
                          **jax_kwargs(side, 1))
    state, perceptual = port_state(side)
    step = make_vqgan_train_step(disc_start=1, perceptual_fn=perceptual)
    j_state = side.state()
    for i in range(len(data)):
        j_state, j_log = j_step(j_state, jnp.asarray(data[i]))
        log = step(state, torch.from_numpy(data[i]))
        assert_logs_match({k: v[None] for k, v in log.items()},
                          jax.tree.map(lambda x: np.asarray(x)[None], j_log),
                          1)
        x = torch.from_numpy(data[i])
        recon, split_log = g_step(split, x)
        if i >= 1:
            split_log.update(d_step(split, x, recon))
        assert_logs_match({k: log[k][None] for k in split_log},
                          {k: v[None] for k, v in split_log.items()}, 1,
                          same=True)
    assert state.step == 3 and state.opt_d.state_dict()["count"] == 2
    assert_moves_match_jax(state, j_state, side, disc_updates=2)
    assert_same_state(state, split)


def test_scan_g_equals_scan_gd_before_disc_start(side):
    data = torch.from_numpy(batches(3, seed=9))
    runs = {}
    for name in ("g", "gd"):
        state, perceptual = port_state(side)
        d_before = {k: v.clone() for k, v in state.disc.state_dict().items()}
        opt_d_before = state.opt_d.state_dict()
        scan_gd, scan_g = make_vqgan_scan_steps(disc_start=100,
                                                perceptual_fn=perceptual)
        logs = (scan_g if name == "g" else scan_gd)(state, data)
        runs[name] = (logs, state)
        # the masked D update left D, its statistics and opt_d as they were
        for k, v in state.disc.state_dict().items():
            assert torch.equal(v, d_before[k]), k
        opt_d_after = state.opt_d.state_dict()
        assert opt_d_after["count"] == opt_d_before["count"] == 0
        for i, s in opt_d_after["inner"]["state"].items():
            assert not s["exp_avg"].any() and not s["exp_avg_sq"].any()
    (g_logs, g_state), (gd_logs, gd_state) = runs["g"], runs["gd"]
    assert "d_loss" not in g_logs and "d_loss" in gd_logs
    assert not gd_logs["d_loss"].any()  # masked: 0 x the loss
    # the same G steps: D's logits are computed either way, gated to 0
    for a, b in zip(g_state.vqvae.state_dict().values(),
                    gd_state.vqvae.state_dict().values()):
        assert torch.equal(a, b)
    for k in g_logs:
        assert torch.equal(g_logs[k], gd_logs[k]), k


TINY = dict(num_users=3, images_per_user_train=6, ch=8, ch_mult=[1, 2],
            num_res_blocks=1, z_channels=8, num_embeddings=8,
            embedding_dim=8, disc_ndf=8, disc_n_layers=2,
            compute_dtype="float32", revive_dead_codes_every=3)


def test_train_vqgan_scan_mode_events_resume_and_split_losses(tmp_path,
                                                              capsys):
    from vqgan_tpu_torch import train_vqgan
    from vqgan_tpu_torch.training import vqgan_trainer

    split = write_image_folder(tmp_path / "data")
    config = tmp_path / "config.json"
    config.write_text(json.dumps(TINY))

    def common(mode):
        return ["--device", "cpu", "--config", str(config), "--split",
                str(split), "--data_path", str(tmp_path / "data"),
                "--results_folder", str(tmp_path / mode), "--image_size",
                "32", "--batch_size", "4", "--disc_start", "2",
                "--save_every", "5", "--step_mode", mode, "--scan_block",
                "2"]

    dispatched = []
    block = vqgan_trainer.VQGANTrainer.dispatch_block

    def spy(self, superbatch, step):
        dispatched.append((step, superbatch.shape[0]))
        return block(self, superbatch, step)

    vqgan_trainer.VQGANTrainer.dispatch_block = spy
    try:
        scan = train_vqgan.main([*common("scan"), "--train_steps", "7"])
    finally:
        vqgan_trainer.VQGANTrainer.dispatch_block = block
    # events: revival at 3 and 6, the save at 5, the end at 7; a block of 2
    # wherever the next event is 2 or more steps away
    assert dispatched == [(0, 2), (2, 1), (3, 2), (5, 1), (6, 1)]
    out = capsys.readouterr().out
    assert "[revive] step 3" in out and "[revive] step 6" in out
    ckpt = CheckpointManager(tmp_path / "scan", prefix="vqgan")
    assert ckpt.all_milestones() == [1, 2] and ckpt.restore()["step"] == 7
    assert ckpt.restore(1)["step"] == 5
    assert len(scan["losses"]) == 7 and all(np.isfinite(scan["losses"]))

    # split mode on the same data: the same losses (the device-state Adam
    # and the masked D update against the eager ones: rounding apart)
    split_run = train_vqgan.main([*common("split"), "--train_steps", "7"])
    np.testing.assert_allclose(scan["losses"], split_run["losses"],
                               rtol=LOSS_RTOL)

    resumed = train_vqgan.main([*common("scan"), "--train_steps", "9",
                                "--resume", "-1"])
    trainer = resumed["trainer"]
    assert trainer.state.step == 9 and len(resumed["losses"]) == 2
    assert trainer.opt_g.state_dict()["count"] == 9
    assert trainer.opt_d.state_dict()["count"] == 7  # from step 2 on


def test_scan_drain_flags_non_finite_losses_and_three_strikes():
    from vqgan_tpu_torch.training.scan_loop import run_scan_loop
    from vqgan_tpu_torch.training.watchdog import TrainingWatchdog

    checked, events = [], []

    class Recording(TrainingWatchdog):
        def check(self, step, loss):
            checked.append(step)
            return super().check(step, loss)

    def loop(values, num_steps, scan_block, save_every, cadences=()):
        checked.clear()
        events.clear()
        values = iter(values)

        def dispatch(step, drawn):
            events.append(("dispatch", step, len(drawn), len(checked)))
            return {}, torch.tensor([next(values) for _ in drawn])

        return run_scan_loop(
            start=0, num_steps=num_steps, scan_block=scan_block,
            batches=(i for i in range(100)), dispatch=dispatch, log_every=0,
            log=None, save_every=save_every,
            save=lambda m: events.append(("save", m, len(checked))),
            watchdog=Recording(), sync=lambda: None, graph_stats=list,
            timing_warmup=0, cadences=cadences)

    nan = float("nan")
    # a dispatch's losses are read after the next dispatch is queued; a
    # non-finite one drains the dispatch just queued at once
    out = loop([1.0, nan, 2.0, 3.0], 4, 1, 0)
    assert [e[3] for e in events[:4]] == [0, 0, 1, 3]
    assert events[4] == ("save", 1, 4)  # cadence 0: only the final save
    assert out["losses"][0] == 1.0 and out["losses"][2:] == [2.0, 3.0]
    # the event rule: full blocks where the next event is a block away,
    # single steps up to it; a save drains first
    loop([1.0] * 7, 7, 2, 3, cadences=(4,))
    assert events == [("dispatch", 0, 2, 0), ("dispatch", 2, 1, 0),
                      ("save", 1, 3), ("dispatch", 3, 1, 3),
                      ("dispatch", 4, 2, 3), ("save", 2, 6),
                      ("dispatch", 6, 1, 6), ("save", 3, 7)]
    # the third non-finite strike in a row raises
    with pytest.raises(TrainingDiverged):
        loop([1.0, nan, nan, nan, 1.0], 5, 1, 0)


def test_auto_resolves_as_the_jax_cli():
    from vqgan_tpu_torch.training.vqgan_trainer import resolve_step_mode

    sys.path.insert(0, str(REPO / "cli"))
    try:
        from train_vqgan import resolve_step_mode as j_resolve
    finally:
        sys.path.pop(0)
    for mode in ("auto", "split", "fused", "scan"):
        for steps in (10, 999, 1000, 30000):
            assert resolve_step_mode(mode, steps) == j_resolve(mode, steps)
    # the ActNorm discriminator decides its initialisation on the device,
    # so the captured modes take it as the JAX trainer does
    from vqgan_tpu_torch.configs import VQGANConfig
    from vqgan_tpu_torch.training.vqgan_trainer import VQGANTrainer

    for mode in ("fused", "scan"):
        trainer = VQGANTrainer(VQGANConfig.from_dict(
            {**TINY, "disc_norm": "act", "image_size": 32}), device="cpu",
            step_mode=mode)
        assert trainer.step_mode == mode
