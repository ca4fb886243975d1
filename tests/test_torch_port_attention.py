"""Port parity: vqgan_tpu_torch.ops.attention against vqgan_tpu.ops.attention.

On the CPU the port's flash path is its plain version; it is held against
the JAX Pallas kernel run in interpret mode (out and LSE) and against the
JAX einsum reference. The CUDA kernel itself is held against the plain
version in `test_kernel_matches_plain_on_gpu`, which needs a card.
"""

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.ops.attention import _flash_forward
from vqgan_tpu.ops.attention import flash_attention as j_flash_attention
from vqgan_tpu.ops.attention import sdpa as j_sdpa
from vqgan_tpu.ops.attention import sdpa_reference as j_sdpa_reference
from vqgan_tpu_torch.ops.attention import (
    flash_attention,
    flash_forward,
    flash_forward_reference,
    sdpa,
    sdpa_reference,
)

torch.set_num_threads(2)

# (B, Sq, Skv, H, D): the ragged shapes of tests/test_attention.py, plus the
# U-Net mid-block head layout at a small batch
SHAPES = [(1, 7, 7, 2, 16), (2, 100, 100, 1, 512), (2, 64, 17, 4, 32),
          (2, 16, 16, 8, 64)]
# fp32 softmax attention on O(1) inputs: the two sides differ only in
# summation order (test_attention.py holds the Pallas kernel to 2e-5 too)
ATOL = 2e-5


def _qkv(b, s_q, s_kv, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s_q, h, d)).astype(np.float32),
            rng.standard_normal((b, s_kv, h, d)).astype(np.float32),
            rng.standard_normal((b, s_kv, h, d)).astype(np.float32))


def _bhsd(x):
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


@pytest.mark.parametrize("b,s_q,s_kv,h,d", SHAPES)
def test_flash_forward_out_and_lse_match_pallas(b, s_q, s_kv, h, d):
    q, k, v = _qkv(b, s_q, s_kv, h, d)
    scale = 1.0 / math.sqrt(d)
    j_out, j_lse = _flash_forward(_bhsd(q), _bhsd(k), _bhsd(v), scale,
                                  block_q=64, block_kv=128, interpret=True)
    out, lse = flash_forward(*map(torch.from_numpy, (q, k, v)))
    assert out.shape == (b, s_q, h, d) and lse.shape == (b, h, s_q)
    np.testing.assert_allclose(
        out.permute(0, 2, 1, 3).reshape(b * h, s_q, d).numpy(),
        np.asarray(j_out), atol=ATOL)
    # lse ~ log(Skv) + O(1): fp32 rounding of a value near 5
    np.testing.assert_allclose(lse.reshape(b * h, s_q).numpy(),
                               np.asarray(j_lse), atol=1e-5)


@pytest.mark.parametrize("b,s_q,s_kv,h,d", SHAPES)
def test_flash_attention_and_sdpa_match_jax(b, s_q, s_kv, h, d):
    q, k, v = _qkv(b, s_q, s_kv, h, d, seed=1)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    j_ref = np.asarray(j_sdpa_reference(jq, jk, jv))
    np.testing.assert_allclose(sdpa_reference(tq, tk, tv).numpy(), j_ref,
                               atol=ATOL)
    np.testing.assert_allclose(sdpa(tq, tk, tv).numpy(),
                               np.asarray(j_sdpa(jq, jk, jv)), atol=ATOL)
    j_flash = j_flash_attention(jq, jk, jv, block_q=64, block_kv=128,
                                interpret=True)
    np.testing.assert_allclose(flash_attention(tq, tk, tv).numpy(),
                               np.asarray(j_flash), atol=ATOL)


def test_flash_forward_bf16_keeps_dtype_and_fp32_lse():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(2, 16, 16, 8, 64, seed=2))
    out, lse = flash_forward(q, k, v)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref = sdpa_reference(q.float(), k.float(), v.float())
    # inputs are exact in bf16; the output is rounded once to bf16 (8 bits)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=1e-2)


def test_extreme_logits_stay_finite():
    q, k, v = map(torch.from_numpy, _qkv(1, 64, 64, 1, 32, seed=3))
    out, lse = flash_forward(q * 100.0, k, v)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    # logits ~100x larger amplify fp32 rounding (as in test_attention.py)
    np.testing.assert_allclose(
        out.numpy(), sdpa_reference(q * 100.0, k, v).numpy(), atol=1e-4)


def test_kernel_wrapper_refuses_cpu_tensors_and_other_devices():
    from vqgan_tpu_torch.kernels.flash_fwd import flash_fwd

    q, k, v = map(torch.from_numpy, _qkv(1, 8, 8, 1, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd(q, k, v, 0.25)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_forward(q.to("meta"), k.to("meta"), v.to("meta"))


def test_library_name_follows_the_headers(tmp_path):
    # a kernel source includes csrc/*.cuh: an edited header must name (and
    # so build) a new library, never load the one built from the old header
    from vqgan_tpu_torch.kernels.build import CudaKernel

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "tiles.cuh"\n')
    (csrc / "tiles.cuh").write_text("// first\n")
    kernel = CudaKernel("k.cu", "k", [])
    kernel.source = csrc / "k.cu"
    first = kernel.library_path
    (csrc / "tiles.cuh").write_text("// second\n")
    assert kernel.library_path != first
    (csrc / "tiles.cuh").write_text("// first\n")
    assert kernel.library_path == first
    (csrc / "k.cu").write_text('#include "tiles.cuh"\n// edited\n')
    assert kernel.library_path != first


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dtype,want_ms", [("float32", 0.2082),
                                           ("bfloat16", 0.01737)])
def test_chip_smoke_bound_takes_each_dtype_at_its_fastest_rate(dtype,
                                                               want_ms):
    # the forward at the main path's [B, 1024, 1, 512] shapes is bound by
    # its operations: bf16 at 989 TFLOP/s; fp32 at fp32 accuracy goes
    # fastest as 3xTF32, three TF32 products at 495 TFLOP/s (not the fp32
    # units' 67 TFLOP/s, which would flatter a kernel)
    smoke = _chip_smoke()
    b = 16 if dtype == "float32" else 8
    itemsize = 4 if dtype == "float32" else 2
    ms, by = smoke.bound(smoke.peaks_for("NVIDIA H100 80GB HBM3"),
                         4 * b * 1024 * 512 * itemsize + 4 * b * 1024,
                         4 * b * 1024 * 1024 * 512, dtype)
    assert by == "operations"
    assert ms == pytest.approx(want_ms, rel=1e-3)


@pytest.mark.parametrize("name,b,dtype,want_ms", [
    ("flash_bwd_dkv", 8, "bfloat16", 0.03474),
    ("flash_bwd_dkv", 16, "float32", 0.4165),
    ("flash_bwd_dkv", 8, "float32", 0.2082),
    ("flash_bwd_dq", 8, "bfloat16", 0.02606),
    ("flash_bwd_dq", 16, "float32", 0.3124),
    ("flash_bwd_dq", 8, "float32", 0.1562)])
def test_chip_smoke_backward_bound(name, b, dtype, want_ms):
    # the backward at the VQ-VAE's bf16 and the KL-VAE's fp32
    # [B, 1024, 1, 512] (batch 8 in KL-VAE training): dK/dV does 8 B S^2 d operations (S^T, dP^T, P^T dO,
    # dS^T Q), dQ 6 B S^2 d, both bound by operations at the dtype's rate
    smoke = _chip_smoke()
    itemsize = 4 if dtype == "float32" else 2
    n_bytes, flops = smoke.backward_work(b, 1024, 1024, 1, 512,
                                         itemsize)[name]
    assert flops == (8 if name == "flash_bwd_dkv" else 6) * b * 1024 ** 2 \
        * 512
    ms, by = smoke.bound(smoke.peaks_for("NVIDIA H100 80GB HBM3"), n_bytes,
                         flops, dtype)
    assert by == "operations"
    assert ms == pytest.approx(want_ms, rel=1e-3)


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv"])
def test_every_flash_source_is_gated_on_the_tensor_cores(name):
    # chip_smoke.py fails unless the SASS of each TENSOR_CORE_SOURCES
    # library holds HMMA instructions; every flash kernel's source is one
    # and is built on the shared tensor-core tiles
    from vqgan_tpu_torch.kernels import KERNELS

    smoke = _chip_smoke()
    assert name in smoke.FLASH
    source = KERNELS[name].source
    assert source.name == f"{name}.cu"
    assert source.name in smoke.TENSOR_CORE_SOURCES
    assert '#include "flash_tc.cuh"' in source.read_text()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s_q,s_kv,h,d", SHAPES + [(16, 1024, 1024, 1, 512)])
def test_kernel_matches_plain_on_gpu(cuda_device, b, s_q, s_kv, h, d, dtype):
    from vqgan_tpu_torch.kernels.flash_fwd import FLASH_FWD, flash_fwd

    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(cuda_device, dt)
               for a in _qkv(b, s_q, s_kv, h, d, seed=4))
    before = FLASH_FWD.launches
    out, lse = flash_fwd(q, k, v, 1.0 / math.sqrt(d))
    torch.cuda.synchronize()
    assert FLASH_FWD.launches == before + 1
    ref_out, ref_lse = flash_forward_reference(q, k, v)
    # same fp32 math in another order; bf16 output rounds once (8 bits)
    atol = 2e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(out.float(), ref_out.float(), atol=atol,
                               rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
