"""The captured step modes on a mesh: `step_mode="scan"` of the LDM
trainer in every `--param_sharding` mode (`sharded_step.
make_sharded_ldm_scan_step`) against its step mode on the same mesh, and
the collectives' refusal inside a CUDA graph capture (`parallel/comm.py`).

On the CPU the scan mode's step bodies run eagerly, so the gloo ranks
hold their math: a small CFG U-Net (dim 16, one level, 2 heads x 16, 8 x 8
x 4 latents, 3 classes, fp32, class dropout 0.5, FSDP cutoff 256
elements), global batch 8, two steps on 2 and 4 ranks (a "model" axis of
2 under the TP modes at 4), the draws from the
trainer's generator in both modes. The logs at SAME_RTOL; the gathered
parameters and EMA within 0.05 x lr per step (the whole-step rule of
`test_torch_port_parallel.py`: the step mode's `LDMOptimizer` and the scan
mode's `CapturableOptimizer` form Adam's bias corrections in other
precisions); every rank bit for bit the same.

The card's part (marked `gpu`, skipped without one): the scan mode on an
NCCL group of one, its graphs holding the collectives, equal bit for bit
to the same step bodies run eagerly; and a gloo collective inside a real
capture refused with a message that names the backend.
"""

import numpy as np
import pytest
import torch

import _torch_dist_workers as workers
from vqgan_tpu_torch.parallel.launch import spawn

torch.set_num_threads(2)

MODES = workers.MODES
LR = 1e-3
B, STEPS = 8, 2
TINY = dict(dim=16, dim_mults=(1,), attn_heads=2, attn_dim_head=16,
            num_users=3, latent_size=8, image_size=64, timesteps=20,
            sampling_timesteps=3, train_batch_size=B, seed=5,
            compute_dtype="float32", cond_drop_prob=0.5, train_lr=LR,
            save_and_sample_every=1000)
MIN_SIZE = 256
SAME_RTOL = 1e-5
SPAWN_TIMEOUT = 300


def _batches(seed=21):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, 8, 8, 4)).astype(np.float32),
             rng.integers(0, 3, B).astype(np.int64)) for _ in range(STEPS)]


@pytest.fixture(scope="module")
def ldm_runs(tmp_path_factory):
    """world -> rank -> (mode, step mode) -> the run."""
    cfg = dict(TINY, results_folder=str(tmp_path_factory.mktemp("ldm")))
    return {world: spawn(workers.ldm_step_and_scan, world,
                         (cfg, MODES, _batches(), MIN_SIZE),
                         timeout=SPAWN_TIMEOUT, threads=2)
            for world in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_scan_on_a_mesh_equals_the_step_mode(ldm_runs, mode, world):
    ranks = ldm_runs[world]
    for rank in ranks:
        step, scan = rank[(mode, "step")], rank[(mode, "scan")]
        assert step["step"] == scan["step"] == STEPS
        for i, (a, b) in enumerate(zip(scan["logs"], step["logs"])):
            assert a.keys() == b.keys()
            np.testing.assert_allclose([a[k] for k in b], [b[k] for k in b],
                                       rtol=SAME_RTOL, err_msg=f"step {i}")
        for part in ("model", "ema"):
            for name, value in step[part].items():
                torch.testing.assert_close(
                    scan[part][name], value, rtol=0, atol=0.05 * LR * STEPS,
                    msg=lambda m: f"{part} {name}: {m}")
    first = ranks[0][(mode, "scan")]
    for other in ranks[1:]:
        assert other[(mode, "scan")]["logs"] == first["logs"]
        for name, value in first["model"].items():
            assert torch.equal(other[(mode, "scan")]["model"][name], value)


def test_a_gloo_collective_is_refused_inside_a_capture():
    messages = spawn(workers.capture_refusal, 1, (),
                     timeout=SPAWN_TIMEOUT)[0]
    assert len(messages) == 3
    for message in messages:
        assert message is not None and "gloo" in message
        assert "capture" in message and "NCCL" in message


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_captured_scan_on_an_nccl_group_of_one_equals_eager(tmp_path, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and CUDA graphs run only "
                    "there")
    cfg = dict(TINY, results_folder=str(tmp_path))
    out = spawn(workers.ldm_scan_captured, 1, (cfg, _batches(), mode),
                timeout=SPAWN_TIMEOUT, backend="nccl", device="cuda")[0]
    (logs_g, model_g, stats), (logs_e, model_e, _) = out[True], out[False]
    assert stats and stats[0]["replays"] > 0
    for a, b in zip(logs_g, logs_e):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    for name, value in model_e.items():
        assert torch.equal(model_g[name], value), name


@pytest.mark.gpu
def test_a_gloo_collective_is_refused_inside_a_real_capture():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs capture only there")
    message = spawn(workers.gloo_in_capture, 1, (), timeout=SPAWN_TIMEOUT,
                    device="cuda")[0]
    assert message is not None and "gloo" in message


def test_dp_check_holds_checkpoints_by_the_norm_rule():
    """`dp_check.compare`: bit for bit; 20 of 100,000 elements flipped by
    Adam's sign-like step (2 lr each: 2.8% of the move in norm) within
    5% of the move in norm; a missed half of the update not."""
    from dp_check import compare

    lr = 1e-3
    n = 100_000
    init = {"w": torch.zeros(n), "running_mean": torch.zeros(4)}
    want = {"w": torch.full((n,), lr), "running_mean": torch.ones(4)}
    same = compare(dict(want), want, init, lr)
    assert same["bit_for_bit"] and same["within_rule"]
    flipped = dict(want, w=want["w"].clone())
    flipped["w"][:20] = -lr
    near = compare(flipped, want, init, lr)
    assert not near["bit_for_bit"] and near["within_rule"]
    assert near["elements_over_5pct_lr"] == pytest.approx(20 / n)
    assert near["move_diff_norm_share"] == pytest.approx(
        2 * (20 / n) ** 0.5, rel=1e-4)
    assert near["max_abs_diff"] == pytest.approx(2 * lr)
    missed = compare(dict(want, w=want["w"] / 2), want, init, lr)
    assert not missed["within_rule"]


def test_dp_check_runs_a_trainer_on_two_ranks_against_one(tmp_path):
    """`tests/dp_check.py --tiny` on the CPU, one run:
    `train_ddpm --self_condition --immiscible` under torchrun on 2 gloo
    ranks and as one process, its checkpoints within the rule."""
    import dp_check

    out = dp_check.main(["--nproc", "2", "--device", "cpu", "--tiny",
                         "--steps", "2", "--runs", "train_ddpm", "--work",
                         str(tmp_path)])
    line = out["train_ddpm"]
    assert out["ok"] and line["world"] == 2 and line["device"] == "cpu"
    assert line["within_rule"] and line["move_diff_norm_share"] < 0.05
    assert (tmp_path / "train_ddpm_n2" / "model-1.pt").exists()


def test_dp_check_witness_on_the_cpu():
    """`tests/dp_check.py --witness --tiny --device cpu`: the VQ-GAN's
    split steps on 2 gloo ranks, the ranks equal; in fp32 within the rule
    of one process and of the interleaved rows; in either dtype no
    farther from one process than twice the distance that rounding alone
    puts between the two row orders."""
    import dp_check

    out = dp_check.main(["--witness", "--device", "cpu", "--tiny",
                         "--steps", "3"])
    assert set(out) == {"bfloat16", "float32"}
    for line in out.values():
        assert line["ranks_equal"] and line["world"] == 2
    for key in ("vs_one_process", "vs_interleaved_rows"):
        assert out["float32"][key]["within_rule"]
        assert out["float32"][key]["elements_over_5pct_lr"] < 0.01
    for line in out.values():
        assert (line["vs_one_process"]["move_diff_norm_share"]
                <= 2 * line["vs_interleaved_rows"]["move_diff_norm_share"])
