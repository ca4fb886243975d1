"""Port parity: the VQ lookup (vqgan_tpu_torch/ops/vq.py) against the JAX
package's (vqgan_tpu/ops/vq.py), on inputs made from numpy seeds.

- The plain version against JAX's exact Pallas kernel (interpret mode, as
  tests/test_vq.py runs it) and its XLA path: indices, z_q and usage
  exactly equal on inputs whose nearest code wins by a clear margin, and on
  duplicate codebook rows (ties go to the lowest index).
- The bf16 mode, held as tests/test_vq.py holds JAX's bf16 kernel.
- Gradients: none to z, the cotangent scatter-added into the codebook.
- `revive_dead_codes` and `reset_codebook_moments` on fixed inputs.
- The kernel wrapper's contract on the CPU, its column padding, the
  smoke's bound of the kernel's work and its tensor-core gate; the kernel
  itself against the plain version in a `gpu`-marked test.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqgan_tpu.ops.vq import codebook_usage as j_usage
from vqgan_tpu.ops.vq import revive_dead_codes as j_revive
from vqgan_tpu.ops.vq import vq_lookup as j_vq_lookup
from vqgan_tpu.training.vqgan_step import make_gan_optimizers as j_gan_opts
from vqgan_tpu.training.vqgan_step import (
    reset_codebook_moments as j_reset_moments,
)
from vqgan_tpu_torch.ops.vq import (
    codebook_usage,
    revive_dead_codes,
    vq_lookup,
    vq_lookup_reference,
    vq_nearest_indices,
)
from vqgan_tpu_torch.training import make_gan_optimizers
from vqgan_tpu_torch.training.vqgan_step import reset_codebook_moments

torch.set_num_threads(2)

# exact agreement where the winner's margin is far above fp32 rounding
EXACT = dict(rtol=0, atol=0)
# gradients: one fp32 scatter-add of the same values on both sides
GRAD_ATOL = 1e-6


def clear_margin_data(n, d, k, seed, duplicates=()):
    """z rows near (0.05 noise) chosen codebook rows of a N(0, 1) codebook:
    the nearest code wins by a margin of order |e|^2. `duplicates`: (i, j)
    pairs, code j set equal to code i."""
    rng = np.random.default_rng(seed)
    codebook = rng.standard_normal((k, d)).astype(np.float32)
    for i, j in duplicates:
        codebook[j] = codebook[i]
    chosen = rng.integers(0, k, n)
    z = codebook[chosen] + 0.05 * rng.standard_normal((n, d)).astype(
        np.float32)
    return z.astype(np.float32), codebook, chosen


@pytest.mark.parametrize("n,d,k", [(64, 16, 33), (1000, 256, 128),
                                   (257, 40, 130)])
def test_plain_version_matches_jax_kernel_and_xla_path(n, d, k):
    z, cb, chosen = clear_margin_data(n, d, k, seed=n)
    zq, idx, usage = vq_lookup(torch.from_numpy(z), torch.from_numpy(cb))
    assert idx.dtype == torch.int32 and usage.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), chosen)
    for use_kernel, interpret in (("fp32", True), (False, False)):
        j_zq, j_idx, j_use = j_vq_lookup(jnp.asarray(z), jnp.asarray(cb),
                                         use_kernel, interpret)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
        np.testing.assert_allclose(zq.numpy(), np.asarray(j_zq), **EXACT)
        np.testing.assert_array_equal(usage.numpy(), np.asarray(j_use))


def test_duplicate_codes_go_to_the_lowest_index():
    # codes 2, 7 and 11 are one point: every row near it ties three ways
    z, cb, chosen = clear_margin_data(50, 8, 12, seed=3,
                                      duplicates=((2, 7), (2, 11)))
    t_idx = vq_lookup(torch.from_numpy(z), torch.from_numpy(cb))[1].numpy()
    _, j_idx, _ = j_vq_lookup(jnp.asarray(z), jnp.asarray(cb), "fp32", True)
    np.testing.assert_array_equal(t_idx, np.asarray(j_idx))
    want = np.where(np.isin(chosen, [7, 11]), 2, chosen)
    np.testing.assert_array_equal(t_idx, want)
    assert (t_idx == 2).any() and not np.isin(t_idx, [7, 11]).any()
    # the bf16 mode breaks its ties the same way
    b_idx = vq_lookup(torch.from_numpy(z), torch.from_numpy(cb), True)[1]
    assert not np.isin(b_idx.numpy(), [7, 11]).any()


def test_bf16_mode_is_near_optimal():
    # as tests/test_vq.py holds the JAX bf16 kernel: the chosen code's true
    # distance is within bf16 rounding slack of the optimum
    rng = np.random.default_rng(2)
    n, d, k = 256, 64, 128
    z = rng.standard_normal((n, d)).astype(np.float32)
    cb = (0.1 * rng.standard_normal((k, d))).astype(np.float32)
    _, idx = vq_lookup_reference(torch.from_numpy(z), torch.from_numpy(cb))
    _, idx_bf, _ = vq_lookup(torch.from_numpy(z), torch.from_numpy(cb), True)
    _, j_idx_bf, _ = j_vq_lookup(jnp.asarray(z), jnp.asarray(cb), True, True)
    zn, cn = z.astype(np.float64), cb.astype(np.float64)
    dist = ((zn[:, None, :] - cn[None, :, :]) ** 2).sum(-1)
    d_best = dist[np.arange(n), idx.numpy()]
    for pick in (idx_bf.numpy(), np.asarray(j_idx_bf)):
        slack = 0.04 * (np.abs((zn * cn[pick]).sum(-1)) + 1.0)
        assert np.all(dist[np.arange(n), pick] <= d_best + slack)
        assert np.mean(pick == idx.numpy()) > 0.95


def test_gradients_go_to_the_codebook_only():
    z, cb, _ = clear_margin_data(50, 8, 16, seed=4)
    w = np.random.default_rng(5).standard_normal((50, 8)).astype(np.float32)

    def j_loss(z, cb):
        z_q, _, _ = j_vq_lookup(z, cb, False, False)
        return jnp.sum(z_q ** 2 * w)

    j_gz, j_gcb = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(z),
                                                   jnp.asarray(cb))
    tz = torch.from_numpy(z).requires_grad_()
    tcb = torch.from_numpy(cb).requires_grad_()
    z_q, _, _ = vq_lookup(tz, tcb)
    (z_q ** 2 * torch.from_numpy(w)).sum().backward()
    assert float(jnp.abs(j_gz).max()) == 0.0
    assert tz.grad is None  # no gradient reaches z
    np.testing.assert_allclose(tcb.grad.numpy(), np.asarray(j_gcb),
                               rtol=0, atol=GRAD_ATOL)


def test_codebook_usage_matches_jax():
    idx = np.array([0, 0, 2, 5, 5, 5, 7], np.int32)
    np.testing.assert_array_equal(
        codebook_usage(torch.from_numpy(idx), 9).numpy(),
        np.asarray(j_usage(jnp.asarray(idx), 9)))


def test_revive_dead_codes_matches_jax_on_fixed_inputs():
    rng = np.random.default_rng(6)
    cb = rng.standard_normal((10, 4)).astype(np.float32)
    usage = np.array([0, 3, 1, 0, 2, 0, 5, 1, 0, 4], np.int32)
    z = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    new, n, dead = revive_dead_codes(torch.from_numpy(cb),
                                     torch.from_numpy(usage),
                                     torch.from_numpy(z),
                                     torch.Generator().manual_seed(0),
                                     threshold=2)
    j_new, j_n, j_dead = j_revive(jnp.asarray(cb), jnp.asarray(usage),
                                  jnp.asarray(z), jax.random.PRNGKey(0),
                                  threshold=2)
    np.testing.assert_array_equal(dead.numpy(), np.asarray(j_dead))
    assert int(n) == int(j_n) == 6
    # live codes keep their rows; a dead code becomes some row of z (the
    # two generators draw different rows)
    live = ~dead.numpy()
    np.testing.assert_array_equal(new.numpy()[live], cb[live])
    np.testing.assert_array_equal(np.asarray(j_new)[live], cb[live])
    rows = z.reshape(-1, 4)
    for code in np.flatnonzero(dead.numpy()):
        assert (rows == new.numpy()[code]).all(axis=1).any()


@pytest.mark.parametrize("accumulate", [1, 2])
def test_reset_codebook_moments_matches_jax(accumulate):
    rng = np.random.default_rng(7)
    init = {"embedding": rng.standard_normal((6, 3)).astype(np.float32),
            "other": rng.standard_normal((4,)).astype(np.float32)}
    kw = dict(learning_rate=1e-2, betas=(0.5, 0.9),
              gradient_accumulate_every=accumulate)
    tx, _ = j_gan_opts(**kw)
    j_params = {"params": {"quantizer": {"embedding": jnp.asarray(
        init["embedding"])}, "other": jnp.asarray(init["other"])}}
    j_state = tx.init(j_params)
    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                for k, v in init.items()}
    opt, _ = make_gan_optimizers(list(t_params.values()),
                                 [torch.nn.Parameter(torch.zeros(1))], **kw)
    for _ in range(2 * accumulate + 1):  # ends mid-accumulation for k = 2
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in init.items()}
        j_grads = {"params": {"quantizer": {"embedding": jnp.asarray(
            g["embedding"])}, "other": jnp.asarray(g["other"])}}
        upd, j_state = tx.update(j_grads, j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        opt.step([torch.from_numpy(g[k]) for k in init])
    dead = np.array([True, False, False, True, False, True])
    j_state = j_reset_moments(j_state, jnp.asarray(dead))
    reset_codebook_moments(opt, t_params["embedding"], torch.from_numpy(dead))

    adam = opt.inner.state[t_params["embedding"]]
    leaves = {jax.tree_util.keystr(path): np.asarray(leaf)
              for path, leaf in jax.tree_util.tree_leaves_with_path(j_state)
              if "embedding" in jax.tree_util.keystr(path)}
    j_mu = next(v for k, v in leaves.items() if ".mu" in k)
    j_nu = next(v for k, v in leaves.items() if ".nu" in k)
    # elementwise fp32 Adam arithmetic on both sides
    np.testing.assert_allclose(adam["exp_avg"].numpy(), j_mu, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(adam["exp_avg_sq"].numpy(), j_nu, rtol=1e-6,
                               atol=1e-7)
    assert not adam["exp_avg"].numpy()[dead].any()
    assert not adam["exp_avg_sq"].numpy()[dead].any()
    assert adam["exp_avg"].numpy()[~dead].all()
    if accumulate > 1:
        j_acc = next(v for k, v in leaves.items() if "acc_grads" in k)
        np.testing.assert_allclose(opt.acc[0].numpy(), j_acc, rtol=1e-6,
                                   atol=1e-7)
        assert not opt.acc[0].numpy()[dead].any()


def test_lookup_contract_on_the_cpu():
    from vqgan_tpu_torch.kernels.vq import vq_nearest

    z, cb, chosen = clear_margin_data(20, 8, 5, seed=8)
    tz, tcb = torch.from_numpy(z), torch.from_numpy(cb)
    idx, usage = vq_nearest_indices(tz, tcb)  # a CPU tensor: plain version
    np.testing.assert_array_equal(idx.numpy(), chosen)
    np.testing.assert_array_equal(usage.numpy(),
                                  np.bincount(chosen, minlength=5))
    with pytest.raises(ValueError, match="CUDA"):
        vq_nearest(tz, tcb, (tcb * tcb).sum(1))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        vq_nearest_indices(tz.to("meta"), tcb.to("meta"))
    with pytest.raises(ValueError, match="use_kernel"):
        vq_lookup(tz, tcb, False)  # the plain version is vq_lookup_reference


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("k,mode,want_ms,want_by", [
    (128, "fp32", 0.0032538, "operations"),  # 537 MFLOP at 165 TFLOP/s
    (128, "bf16", 0.0025533, "bytes"),       # 8.55 MB at 3.35 TB/s
    (8192, "fp32", 0.20824, "operations"),   # 34.4 GFLOP at 165 TFLOP/s
])
def test_chip_smoke_vq_bound(k, mode, want_ms, want_by):
    # the search over z [8192, 256] (a batch of 8 32x32 latent grids): fp32
    # at 3xTF32's rate, bf16 at the bf16 rate, where the fp32 inputs'
    # bytes take longer than the products
    smoke = _chip_smoke()
    n_bytes, flops = smoke.vq_work(8192, k, 256)
    assert flops == 2 * 8192 * k * 256
    assert n_bytes == 4 * (8192 * 256 + k * 256 + 2 * k + 8192)
    ms, by = smoke.bound(smoke.peaks_for("NVIDIA H100 80GB HBM3"), n_bytes,
                         flops, "float32" if mode == "fp32" else "bfloat16")
    assert by == want_by
    assert ms == pytest.approx(want_ms, rel=1e-4)


def test_vq_source_is_gated_on_the_tensor_cores():
    # chip_smoke.py fails unless the SASS of each TENSOR_CORE_SOURCES
    # library holds HMMA instructions; the VQ kernel is one, built on the
    # flash kernels' tensor-core tiles
    from vqgan_tpu_torch.kernels import KERNELS

    source = KERNELS["vq_nearest"].source
    assert source.name == "vq.cu"
    assert source.name in _chip_smoke().TENSOR_CORE_SOURCES
    assert '#include "flash_tc.cuh"' in source.read_text()


def _column_ordered_scores(z, codebook, mode):
    """The plain version's scores with every sum taken column by column in
    index order, so that zero columns appended at the end add exactly 0."""
    z32, e32 = z.float(), codebook.float()
    if mode == "bf16":
        z32, ex = z32.bfloat16().float(), e32.bfloat16().float()
    else:
        ex = e32
    cross = torch.zeros(z.shape[0], codebook.shape[0])
    z_sq = torch.zeros(z.shape[0], 1)
    e_sq = torch.zeros(codebook.shape[0])
    for c in range(z.shape[1]):
        cross = cross + z32[:, c:c + 1] * ex[:, c]
        z_sq = z_sq + z32[:, c:c + 1] * z32[:, c:c + 1]
        e_sq = e_sq + e32[:, c] * e32[:, c]
    if mode == "bf16":
        return e_sq - 2.0 * cross
    return (z_sq + e_sq) - 2.0 * cross


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [33, 40, 3, 17])
def test_staged_padding_keeps_scores_and_indices(d, dtype):
    # the wrapper pads rows to 16 bytes with zero columns (D = 33: fp32 to
    # 36, bf16 to 40); the padded plain version picks the same codes with
    # the same scores, bit for bit
    from vqgan_tpu_torch.kernels.vq import staged
    from vqgan_tpu_torch.ops.vq import vq_scores

    mode = "fp32" if dtype == torch.float32 else "bf16"
    rng = np.random.default_rng(d)
    z = torch.from_numpy(rng.standard_normal((257, d)).astype(np.float32))
    cb = torch.from_numpy(rng.standard_normal((130, d)).astype(np.float32))
    zp, cbp = staged(z, dtype), staged(cb, dtype)
    step = 16 // zp.element_size()
    assert zp.dtype == dtype and zp.is_contiguous()
    assert zp.shape == (257, -(-d // step) * step)
    assert zp.data_ptr() % 16 == 0 and cbp.data_ptr() % 16 == 0
    assert torch.equal(zp[:, :d], z.to(dtype))
    assert not zp[:, d:].any() and not cbp[:, d:].any()
    # the codebook as fp32 at the staged width: its bf16 rounding is the
    # bf16 staging, and its norms are the |e|^2 the wrapper passes in
    cbw = torch.nn.functional.pad(cb, (0, zp.shape[1] - d))
    assert torch.equal(cbp, cbw.to(dtype))
    zp = zp.float()  # bf16 staging rounds what the bf16 mode rounds anyway
    if mode == "fp32":
        # BLAS keeps its summation blocking for a pad to the next 4
        want = vq_scores(z, cb, mode)
        got = vq_scores(zp, cbw, mode)
        assert torch.equal(got, want)
        assert torch.equal(got.argmin(1), want.argmin(1))
    want = _column_ordered_scores(z, cb, mode)
    got = _column_ordered_scores(zp, cbw, mode)
    assert torch.equal(got, want)
    assert torch.equal(got.argmin(1), want.argmin(1))
    _, idx = vq_lookup_reference(z, cb, mode)
    _, idx_p = vq_lookup_reference(zp, cbw, mode)
    assert torch.equal(idx_p, idx)


def test_staged_returns_a_ready_input_itself():
    from vqgan_tpu_torch.kernels.vq import staged

    x = torch.ones(5, 8)
    assert staged(x, torch.float32) is x
    y = staged(x.t().contiguous().t(), torch.float32)  # strided: a copy
    assert y.is_contiguous() and torch.equal(y, x)
    view = torch.arange(41.0)[1:].view(5, 8)  # rows start 4 bytes off
    assert view.data_ptr() % 16 == 4
    y = staged(view, torch.float32)  # an aligned copy
    assert y.data_ptr() % 16 == 0 and torch.equal(y, view)


def test_bench_vq_takes_source_copies_and_needs_a_card(monkeypatch):
    # bench_vq times the package's vq.cu beside copies of it, each named
    # once; without a card it raises before it builds anything
    from vqgan_tpu_torch import bench_vq
    from vqgan_tpu_torch.kernels.vq import VQ_NEAREST

    sources = bench_vq.parse_variants(["wide=other/vq.cu"])
    assert list(sources) == ["shipped", "wide"]
    assert sources["shipped"] == VQ_NEAREST.source
    assert sources["wide"] == Path("other/vq.cu")
    for bad in ["wide", "wide=-DX=1", "=a.cu", "shipped=a.cu"]:
        with pytest.raises(ValueError, match="NAME=PATH"):
            bench_vq.parse_variants([bad])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench_vq, "_start_build", None)  # never reached
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_vq.main(["--variant", "wide=other/vq.cu"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the VQ kernel runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("n,d,k", [(8192, 256, 128), (777, 40, 130),
                                   (777, 33, 130), (8192, 256, 8192),
                                   (300, 300, 70)])
def test_kernel_matches_plain_on_gpu(cuda_device, n, d, k, mode):
    from vqgan_tpu_torch.kernels.vq import VQ_NEAREST

    z, cb, _ = clear_margin_data(n, d, k, seed=9)
    tz, tcb = (torch.from_numpy(a).to(cuda_device) for a in (z, cb))
    before = VQ_NEAREST.launches
    idx, usage = vq_nearest_indices(tz, tcb, mode)
    torch.cuda.synchronize()
    assert VQ_NEAREST.launches == before + 1
    _, ref = vq_lookup_reference(tz, tcb, mode)
    # clear margins: no near-tie for a summation order to flip
    torch.testing.assert_close(idx, ref, rtol=0, atol=0)
    torch.testing.assert_close(usage, codebook_usage(ref, k), rtol=0, atol=0)
