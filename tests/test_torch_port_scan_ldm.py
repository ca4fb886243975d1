"""Port parity: the stage-2 scan mode (`make_ldm_scan_step`, the
`CapturableOptimizer`, the device-step EMA, the trainer's `step_mode`
"scan" and its CLI flags) against the JAX package, on the CPU.

The harness of `test_torch_port_train.py`: a small CFG U-Net (dim 16,
mults (1, 2), 2 heads x 16, 8x8x4 latents, 3 classes) in fp32 on both
sides, the JAX params filled from a numpy seed and carried into the port
with `cfg_unet_state_from_jax`; t, noise and the cond-drop mask injected
on both sides.

- The device-state optimizer against optax (clipping, AdamW, warmup,
  MultiSteps k = 2), its masked update, and its checkpoint round trip with
  `LDMOptimizer`.
- The device-step EMA against JAX's over the warm copy and the ramp.
- A block of 4 steps against JAX's per-step composition (the harness of
  `test_train_steps_match_the_jax_composition`), from start 0, 97 and 98
  (the EMA's cadence, warm copy and first ramped step inside the block),
  and with the contrastive gate crossing its start, warmup and
  accumulation 2.
- The block against single-step dispatches bit for bit, and against the
  eager step's draws from one generator.
- `graphs.py`: replay accounting over a stub counter; CPU tensors refused.
- The scan-mode trainer: its event rule, losses equal to step mode's, the
  drain of a non-finite loss, resume, and `auto`.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqgan_tpu.losses.contrastive import supcon_loss as j_supcon
from vqgan_tpu.training.ema import ema_update as j_ema_update
from vqgan_tpu.training.ldm_step import make_ldm_optimizer as j_optimizer
from vqgan_tpu_torch.checkpoint.from_jax import cfg_unet_state_from_jax
from vqgan_tpu_torch.diffusion import GaussianDiffusion
from vqgan_tpu_torch.graphs import BlockRunner, Graphed, LaunchRecord
from vqgan_tpu_torch.training import (
    LDMTrainState,
    ema_update,
    make_ldm_optimizer,
    make_ldm_train_step,
)
from vqgan_tpu_torch.training.ldm_step import make_ldm_scan_step

from test_torch_port_train import DIFF, JaxSide, port_model

torch.set_num_threads(2)

K, B = 4, 4


@pytest.fixture(scope="module")
def jax_side():
    return JaxSide()


def block_data(seed, k=K, b=B):
    rng = np.random.default_rng(seed)
    return dict(x=rng.standard_normal((k, b, 8, 8, 4)).astype(np.float32),
                t=rng.integers(0, 20, (k, b)).astype(np.int32),
                classes=np.tile(np.arange(b) % 3, (k, 1)).astype(np.int32),
                noise=rng.standard_normal((k, b, 8, 8, 4)).astype(np.float32),
                mask=rng.random((k, b)) < 0.5)


def jax_features_loss(side):
    """JAX's value_and_grad of p_losses + weight * gate * SupCon of the
    mid-block features, the cond-drop mask injected as in `JaxSide`."""

    @jax.jit
    def loss_and_grads(params, x, t, classes, noise, mask, weight, gate):
        side.mask = mask

        def loss_fn(p):
            diff, feats = side.diffusion.p_losses(
                p, jax.random.PRNGKey(0), x, t, classes, noise=noise,
                return_features=True)
            closs = j_supcon(feats[:, None, :], classes, temperature=0.07)
            return diff + weight * gate * closs

        return jax.value_and_grad(loss_fn)(params)

    return loss_and_grads


def port_state(jax_params, *, capturable=True, **opt_kw):
    net = port_model(jax_params)
    opt = make_ldm_optimizer(net.parameters(), capturable=capturable,
                             **opt_kw)
    return net, LDMTrainState(0, net, copy.deepcopy(net).requires_grad_(False),
                              opt)


def to_torch(data):
    return dict(latents=torch.from_numpy(data["x"]),
                classes=torch.from_numpy(data["classes"]).long(),
                t=torch.from_numpy(data["t"]).long(), noise=data["noise"],
                cond_drop_mask=torch.from_numpy(data["mask"]))


def test_capturable_optimizer_matches_optax_and_masks():
    rng = np.random.default_rng(7)
    shapes = {"a": (4, 3), "b": (6,), "c": (2, 5)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    kw = dict(learning_rate=1e-2, weight_decay=1e-2, betas=(0.9, 0.99),
              max_grad_norm=1.0, warmup_steps=2, gradient_accumulate_every=2)
    tx = j_optimizer(**kw)
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    j_state = tx.init(j_params)
    t_params = [torch.nn.Parameter(torch.from_numpy(v.copy()))
                for v in init.values()]
    opt = make_ldm_optimizer(t_params, capturable=True, **kw)
    for i in range(7):
        scale = [0.3, 2.0, 0.5, 3.0, 0.2, 0.4, 1.5][i]
        grads = {k: (rng.standard_normal(s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        frozen = i == 2  # a masked call changes nothing
        before = [t.detach().clone() for t in t_params]
        state_before = copy.deepcopy(opt.state_dict())
        opt.step([torch.from_numpy(g) for g in grads.values()],
                 active=torch.tensor(not frozen))
        if frozen:
            assert all(torch.equal(a, b) for a, b in zip(before, t_params))
            after = opt.state_dict()
            assert after["count"] == state_before["count"]
            assert after["mini_step"] == state_before["mini_step"]
            for a, b in zip(after["acc"], state_before["acc"]):
                assert torch.equal(a, b)
            continue
        upd, j_state = tx.update({k: jnp.asarray(v)
                                  for k, v in grads.items()},
                                 j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        for t, key in zip(t_params, shapes):
            # elementwise fp32 Adam arithmetic (the bias corrections and
            # the learning rate as fp32 device scalars), the norm the only
            # reduction
            np.testing.assert_allclose(t.detach().numpy(),
                                       np.asarray(j_params[key]),
                                       rtol=1e-6, atol=2e-7,
                                       err_msg=f"call {i}, {key}")
    assert opt.state_dict()["count"] == 3
    assert opt.lr_at(torch.tensor(1.0)).item() == np.float32(5e-3)


def test_capturable_checkpoint_resumes_in_the_eager_optimizer():
    # a CapturableOptimizer's state dict loads into LDMOptimizer and back,
    # and both then take the same next update
    rng = np.random.default_rng(8)
    init = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    kw = dict(learning_rate=1e-2, weight_decay=1e-2, betas=(0.9, 0.99),
              max_grad_norm=1.0, warmup_steps=3)
    grads = [[torch.from_numpy(rng.standard_normal(a.shape).astype(
        np.float32)) for a in init] for _ in range(3)]

    def params():
        return [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]

    p_cap, p_eager, p_back = params(), params(), params()
    cap = make_ldm_optimizer(p_cap, capturable=True, **kw)
    for g in grads[:2]:
        cap.step([x.clone() for x in g])
    eager = make_ldm_optimizer(p_eager, **kw)
    eager.load_state_dict(copy.deepcopy(cap.state_dict()))
    back = make_ldm_optimizer(p_back, capturable=True, **kw)
    back.load_state_dict(copy.deepcopy(eager.state_dict()))
    with torch.no_grad():
        for a, b, c in zip(p_cap, p_eager, p_back):
            b.copy_(a)
            c.copy_(a)
    assert eager.count == 2 and back.state_dict()["count"] == 2
    cap.step([x.clone() for x in grads[2]])
    eager.step([x.clone() for x in grads[2]])
    back.step([x.clone() for x in grads[2]])
    for a, b, c in zip(p_cap, p_eager, p_back):
        assert torch.equal(a, c)
        # host-double against device-fp32 bias corrections
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_device_step_ema_matches_jax_and_the_host_step():
    # update_every 2, update_after_step 6: warm copies on even steps to 6,
    # ramped mixes on 8..14, odd steps untouched
    rng = np.random.default_rng(6)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    j_ema = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    dev_ema = [torch.from_numpy(a.copy()) for a in j_ema]
    host_ema = [torch.from_numpy(a.copy()) for a in j_ema]
    kw = dict(decay=0.9, update_every=2, update_after_step=6)
    for step in range(15):
        new = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        j_ema = j_ema_update(j_ema, [jnp.asarray(a) for a in new],
                             jnp.asarray(step), **kw)
        ema_update(dev_ema, [torch.from_numpy(a) for a in new],
                   torch.tensor(step), **kw)
        ema_update(host_ema, [torch.from_numpy(a) for a in new], step, **kw)
        for a, b, c in zip(dev_ema, j_ema, host_ema):
            # one fp32 multiply-add per step, as in test_torch_port_train
            # (XLA may fuse JAX's into one rounding)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       err_msg=f"step {step}")
            np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-6,
                                       err_msg=f"step {step}")


def jax_steps(side, params, data, start, *, opt_kw, ema_kw, weight=0.0,
              contrastive_start=0):
    """JAX's per-step composition over the block: value_and_grad, update,
    apply_updates, ema_update at state.step."""
    tx = j_optimizer(**opt_kw)

    @jax.jit
    def update(grads, opt_state, params, ema, step):
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = j_ema_update(ema, params, step, **ema_kw)
        return opt_state, params, ema, optax.global_norm(grads)

    params = jax.tree.map(jnp.asarray, params)
    opt_state, ema = tx.init(params), params
    features = jax_features_loss(side) if weight else None
    logs = []
    for i in range(data["x"].shape[0]):
        args = (data["x"][i], data["t"][i], data["classes"][i],
                data["noise"][i], data["mask"][i])
        if features is None:
            loss, grads = side.loss_and_grads(params, *args)
        else:
            gate = float(start + i >= contrastive_start)
            loss, grads = features(params, *args, weight, gate)
        opt_state, params, ema, norm = update(grads, opt_state, params, ema,
                                              jnp.asarray(start + i))
        logs.append((float(loss), float(norm)))
    return np.asarray(logs), params, ema


def assert_state_matches_jax(state, params, ema, lr):
    # the tolerance of test_train_steps_match_the_jax_composition: Adam
    # moves each weight by ~lr per update, and fp32 gradients that agree to
    # ~1e-6 relative keep the weights within a small fraction of lr
    for tree, module in ((params, state.model), (ema, state.ema_model)):
        want = cfg_unet_state_from_jax(jax.tree.map(np.asarray, tree))
        for name, value in module.state_dict().items():
            torch.testing.assert_close(value, want[name], rtol=0,
                                       atol=0.05 * lr,
                                       msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("start", [0, 97, 98])
def test_scan_block_matches_the_jax_composition(jax_side, start):
    lr = 1e-3
    opt_kw = dict(learning_rate=lr, weight_decay=1e-4, betas=(0.9, 0.99),
                  max_grad_norm=1.0)
    # steps 97-101 hold a skipped step, the last warm copy (98) and the
    # first ramped mixes (100: epoch 1)
    ema_kw = dict(decay=0.995, update_every=2, update_after_step=98)
    data = block_data(20 + start)
    j_logs, params, ema = jax_steps(jax_side, jax_side.params, data, start,
                                    opt_kw=opt_kw, ema_kw=ema_kw)

    _, state = port_state(jax_side.params, **opt_kw)
    state.step = start
    diffusion = GaussianDiffusion(state.model, **DIFF, device="cpu")
    block = make_ldm_scan_step(
        diffusion, state.optimizer, ema_decay=ema_kw["decay"],
        ema_update_every=ema_kw["update_every"],
        ema_update_after_step=ema_kw["update_after_step"])
    x = to_torch(data)
    logs = block(state, x.pop("latents"), x.pop("classes"), **x)
    assert state.step == start + K
    assert set(logs) == {"loss", "diffusion_loss", "grad_norm"}
    assert logs["loss"].shape == (K,)
    # fp32 forward and backward in another summation order
    np.testing.assert_allclose(
        np.stack([logs["loss"].numpy(), logs["grad_norm"].numpy()], 1),
        j_logs, rtol=1e-4)
    assert_state_matches_jax(state, params, ema, lr)


def test_scan_block_contrastive_warmup_accumulation(jax_side):
    # the SupCon gate opens inside the block (steps 2, 3), the learning
    # rate warms up over 3 updates, and MultiSteps k = 2 applies an update
    # every second step
    lr = 1e-3
    opt_kw = dict(learning_rate=lr, weight_decay=1e-4, betas=(0.9, 0.99),
                  max_grad_norm=1.0, warmup_steps=3,
                  gradient_accumulate_every=2)
    ema_kw = dict(decay=0.995, update_every=1, update_after_step=0)
    data = block_data(31)
    j_logs, params, ema = jax_steps(jax_side, jax_side.params, data, 0,
                                    opt_kw=opt_kw, ema_kw=ema_kw,
                                    weight=0.5, contrastive_start=2)

    _, state = port_state(jax_side.params, **opt_kw)
    diffusion = GaussianDiffusion(state.model, **DIFF, device="cpu")
    block = make_ldm_scan_step(
        diffusion, state.optimizer, contrastive_weight=0.5,
        contrastive_start_step=2, ema_decay=ema_kw["decay"],
        ema_update_every=1, ema_update_after_step=0)
    x = to_torch(data)
    logs = block(state, x.pop("latents"), x.pop("classes"), **x)
    assert "contrastive_loss" in logs
    np.testing.assert_allclose(logs["loss"].numpy(), j_logs[:, 0], rtol=1e-4)
    assert state.optimizer.state_dict()["count"] == 2
    assert_state_matches_jax(state, params, ema, lr)


def flat(module):
    return torch.cat([v.detach().flatten().float()
                      for v in module.state_dict().values()])


def test_block_equals_single_dispatches_and_the_eager_draws(jax_side):
    # drawn t, noise and cond-drop mask: one block of 4 against 4
    # single-step dispatches bit for bit (the same device-step body on the
    # CPU), and against 4 eager steps drawing from a generator of the same
    # seed (the same draws; the eager path's EMA and Adam scalars are host
    # doubles, so rounding apart)
    kw = dict(learning_rate=1e-3, weight_decay=1e-4, betas=(0.9, 0.99),
              max_grad_norm=1.0)
    step_kw = dict(cond_drop_prob=0.5, ema_update_every=1,
                   ema_update_after_step=1)
    data = block_data(40)
    lat = torch.from_numpy(data["x"])
    cls = torch.from_numpy(data["classes"]).long()
    runs = {}
    for how in ("block", "single", "eager"):
        _, state = port_state(jax_side.params, capturable=how != "eager",
                              **kw)
        diffusion = GaussianDiffusion(state.model, **DIFF, device="cpu")
        gen = torch.Generator().manual_seed(3)
        if how == "eager":
            step = make_ldm_train_step(diffusion, state.optimizer, **step_kw)
            losses = [step(state, lat[i], cls[i], generator=gen)["loss"]
                      for i in range(K)]
        else:
            block = make_ldm_scan_step(diffusion, state.optimizer, **step_kw)
            if how == "block":
                losses = list(block(state, lat, cls, generator=gen)["loss"])
            else:
                losses = [block(state, lat[i:i + 1], cls[i:i + 1],
                                generator=gen)["loss"][0] for i in range(K)]
        assert state.step == K
        runs[how] = (torch.stack(losses), flat(state.model),
                     flat(state.ema_model), gen.get_state())
    for a, b in zip(runs["block"], runs["single"]):
        assert torch.equal(a, b)
    assert torch.equal(runs["block"][3], runs["eager"][3])
    torch.testing.assert_close(runs["block"][0], runs["eager"][0],
                               rtol=1e-5, atol=0)
    for a, b in zip(runs["block"][1:3], runs["eager"][1:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-6)


class StubKernel:
    def __init__(self):
        self.launches = 0
        self.launches_by_shape = {}

    def count(self, shape):
        self.launches += 1
        self.launches_by_shape[shape] = self.launches_by_shape.get(shape,
                                                                   0) + 1


def test_launch_record_adds_the_captured_launches_at_each_replay():
    kernel, idle = StubKernel(), StubKernel()
    kernel.count((1, 2))
    record = LaunchRecord({"kernel": kernel, "idle": idle})
    with record.capturing():  # a capture counts, but launches nothing
        kernel.count((1, 2))
        kernel.count((3,))
        kernel.count((3,))
    assert kernel.launches == 1 and kernel.launches_by_shape == {(1, 2): 1}
    assert record.per_replay() == {"kernel": 3}
    for _ in range(2):
        record.replay()
    assert kernel.launches == 7
    assert kernel.launches_by_shape == {(1, 2): 3, (3,): 4}
    assert idle.launches == 0 and idle.launches_by_shape == {}


def test_graphs_refuse_cpu_tensors_and_runners_run_them_eagerly():
    calls = []

    def body(generators, x):
        calls.append(x.shape[0])
        return (x * 2,)

    with pytest.raises(ValueError, match="CUDA graph"):
        Graphed(body, counters={})(torch.ones(2, 3))
    assert calls == []
    out, = BlockRunner(body)(torch.ones(4, 3))
    assert calls == [4] and torch.equal(out, torch.full((4, 3), 2.0))


def test_train_latent_cfg_scan_mode_events_resume_and_step_losses(tmp_path):
    import json

    from test_torch_port_trainer import TINY, write_data
    from vqgan_tpu_torch import train_latent_cfg
    from vqgan_tpu_torch.checkpoint import CheckpointManager
    from vqgan_tpu_torch.training import ldm_trainer

    split = write_data(tmp_path, missing=False)
    config = tmp_path / "config.json"
    config.write_text(json.dumps(TINY))  # save_and_sample_every 4

    def common(mode):
        return ["--device", "cpu", "--config", str(config), "--split",
                str(split), "--latents_cache_folder", str(tmp_path / "cache"),
                "--results_folder", str(tmp_path / mode),
                "--train_batch_size", "4", "--step_mode", mode,
                "--scan_block", "2"]

    dispatched = []
    block = ldm_trainer.LatentDiffusionTrainer.dispatch_block

    def spy(self, latents, labels):
        dispatched.append((self.state.step, len(latents)))
        return block(self, latents, labels)

    ldm_trainer.LatentDiffusionTrainer.dispatch_block = spy
    try:
        scan = train_latent_cfg.main([*common("scan"),
                                      "--train_num_steps", "7"])
    finally:
        ldm_trainer.LatentDiffusionTrainer.dispatch_block = block
    # events: the save at 4, the end at 7; blocks of 2 wherever the next
    # event is 2 or more steps away, single steps up to it
    assert dispatched == [(0, 2), (2, 2), (4, 2), (6, 1)]
    ckpt = CheckpointManager(tmp_path / "scan", prefix="model")
    assert ckpt.all_milestones() == [1, 2] and ckpt.restore()["step"] == 7
    assert ckpt.restore(1)["step"] == 4
    assert len(scan["losses"]) == 7 and all(np.isfinite(scan["losses"]))

    # step mode on the same data and seeds: the same draws, so the same
    # losses (the eager path's EMA and Adam scalars are host doubles)
    step = train_latent_cfg.main([*common("step"), "--train_num_steps", "7"])
    np.testing.assert_allclose(scan["losses"], step["losses"], rtol=1e-5)

    # a scan-mode checkpoint resumes in step mode and in scan mode
    resumed = train_latent_cfg.main([*common("scan"), "--train_num_steps",
                                     "9", "--resume", "-1"])
    trainer = resumed["trainer"]
    assert trainer.state.step == 9 and len(resumed["losses"]) == 2
    assert trainer.optimizer.state_dict()["count"] == 9
    eager = train_latent_cfg.main([*common("step"), "--results_folder",
                                   str(tmp_path / "scan"), "--train_num_steps",
                                   "10", "--resume", "-1"])
    assert eager["trainer"].optimizer.count == 10


def test_scan_drain_and_auto(tmp_path):
    from vqgan_tpu_torch.configs import LDMConfig
    from vqgan_tpu_torch.training.ldm_trainer import (
        LatentDiffusionTrainer,
        resolve_step_mode,
    )
    from vqgan_tpu_torch.training.scan_loop import drain_block_losses
    from vqgan_tpu_torch.training.watchdog import TrainingDiverged

    from test_torch_port_trainer import TINY

    trainer = LatentDiffusionTrainer(
        LDMConfig.from_dict({**TINY, "results_folder": str(tmp_path)}),
        device="cpu", step_mode="scan", scan_block=2)
    losses, nan = [], float("nan")
    wd = trainer.watchdog
    assert not drain_block_losses(wd, (2, torch.tensor([1.0, 2.0])), losses)
    assert drain_block_losses(wd, (4, torch.tensor([1.0, nan])), losses)
    with pytest.raises(TrainingDiverged):  # the third strike in a row
        drain_block_losses(wd, (6, torch.tensor([nan, nan])), losses)
    # the JAX CLI's rule (cli/train_latent_cfg.py): scan from 1000 steps
    assert [resolve_step_mode("auto", n) for n in (10, 999, 1000)] == [
        "step", "step", "scan"]
    assert resolve_step_mode("step", 5000) == "step"
    assert resolve_step_mode("scan", 5) == "scan"
    with pytest.raises(ValueError, match="step_mode"):
        LatentDiffusionTrainer(LDMConfig.from_dict(TINY), device="cpu",
                               step_mode="fused")
