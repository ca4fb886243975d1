"""Port parity: ring attention (vqgan_tpu_torch/ops/ring_attention.py)
against the JAX package's `ring_attention` on its CPU "seq" mesh and
against full attention.

On the CPU each ring step takes the flash kernels' plain versions (the
kernels' math in fp32); on the card the same calls launch the kernels.
Inputs from a numpy seed: q [2, 64, 2, 16], k/v [2, 48, 2, 16].

- `attention_with_lse` and the fp32 merge against JAX's (atol 1e-5).
- `ring_attention_shards` (one process, n blocks) and `ring_attention`
  (n gloo ranks, spawned with a deadline), n = 1, 2, 4: fp32 output and
  gradients (`do` from the seed) against JAX's ring and its `jax.grad` on
  n CPU devices, and against `sdpa_reference`, at atol 1e-5.
- bf16: the distance of the output and of each gradient from the fp64
  reference is at most twice that of the whole-sequence flash attention
  in bf16 (the rule of ROADMAP §3: gate bf16 on the fp64 distance). The
  backward kernels write each block's dK/dV partial in bf16 before the
  fp32 sum, n roundings where the whole-sequence call has one.
- Sequence lengths that do not divide raise JAX's message.
- On the card (marked gpu, skipped here): n^2 launches of the forward
  kernel per call and n^2 of each backward kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import _torch_dist_workers as workers
from vqgan_tpu.ops.ring_attention import _merge as j_merge
from vqgan_tpu.ops.ring_attention import attention_with_lse as j_with_lse
from vqgan_tpu.ops.ring_attention import ring_attention as j_ring
from vqgan_tpu_torch.ops.attention import flash_attention, sdpa_reference
from vqgan_tpu_torch.ops.ring_attention import (
    _merge,
    attention_with_lse,
    ring_attention,
    ring_attention_shards,
)
from vqgan_tpu_torch.parallel import Mesh
from vqgan_tpu_torch.parallel.launch import spawn

torch.set_num_threads(2)

ATOL = 1e-5
BF16_FACTOR = 2.0
SPAWN_TIMEOUT = 120


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    shapes = ((2, 64, 2, 16), (2, 48, 2, 16), (2, 48, 2, 16), (2, 64, 2, 16))
    return tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)


def _attention_fp64(q, k, v):
    """Softmax attention in float64 throughout (`sdpa_reference` computes
    in fp32)."""
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k)
                      / np.sqrt(q.shape[-1]), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.fixture(scope="module")
def reference(qkv):
    """fp64 output and gradients of full attention, and `sdpa_reference`'s
    fp32 ones."""
    q, k, v, do = qkv
    ins = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
    out = _attention_fp64(*ins)
    out.backward(torch.from_numpy(do).double())
    plain = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    p_out = sdpa_reference(*plain)
    p_out.backward(torch.from_numpy(do))
    return (out.detach(), [t.grad for t in ins], p_out.detach(),
            [t.grad for t in plain])


@pytest.fixture(scope="module")
def jax_ring(qkv):
    """n -> JAX's fp32 ring output and gradients on n CPU devices."""
    q, k, v, do = (jnp.asarray(a) for a in qkv)
    out = {}
    for n in (1, 2, 4):
        mesh = JMesh(np.asarray(jax.devices()[:n]), ("seq",))
        fn = jax.jit(lambda q, k, v: j_ring(q, k, v, mesh))
        o, vjp = jax.vjp(fn, q, k, v)
        out[n] = (np.asarray(o), [np.asarray(g) for g in vjp(do)])
    return out


@pytest.fixture(scope="module")
def spawned(qkv):
    """world -> rank -> dtype -> (output block, grad blocks)."""
    return {n: spawn(workers.ring, n, (*qkv, ("float32", "bfloat16")),
                     timeout=SPAWN_TIMEOUT) for n in (2, 4)}


def _run_shards(qkv, n, dtype):
    q, k, v, do = qkv
    ins = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = ring_attention_shards(*ins, n)
    out.backward(torch.from_numpy(do).to(dtype))
    return out.detach().float(), [t.grad.float() for t in ins]


def _gathered(ranks, dtype):
    parts = [r[dtype] for r in ranks]
    return (torch.cat([p[0] for p in parts], 1),
            [torch.cat([p[i] for p in parts], 1) for i in (1, 2, 3)])


def test_attention_with_lse_and_merge_match_jax(qkv):
    q, k, v, _ = qkv
    out, lse = attention_with_lse(*(torch.from_numpy(a) for a in (q, k, v)))
    j_out, j_lse = j_with_lse(*(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=ATOL)
    out2, lse2 = attention_with_lse(*(torch.from_numpy(a[:, ::-1].copy())
                                      for a in (q, k, v)))
    got = _merge(out, lse, out2, lse2)
    want = j_merge(j_out, j_lse, jnp.asarray(out2.numpy()),
                   jnp.asarray(lse2.numpy()))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_shards_match_jax_ring_and_full_attention_fp32(qkv, reference,
                                                       jax_ring, n):
    out, grads = _run_shards(qkv, n, torch.float32)
    _fp32_gates(out, grads, jax_ring[n], reference)


def _fp32_gates(out, grads, jax_result, reference):
    """fp32: against JAX's ring, `sdpa_reference` and fp64, atol 1e-5."""
    j_out, j_grads = jax_result
    np.testing.assert_allclose(out.numpy(), j_out, atol=ATOL)
    torch.testing.assert_close(out, reference[2], atol=ATOL, rtol=0)
    torch.testing.assert_close(out.double(), reference[0], atol=ATOL, rtol=0)
    for g, jg, plain, ref in zip(grads, j_grads, reference[3], reference[1]):
        np.testing.assert_allclose(g.numpy(), jg, atol=ATOL)
        torch.testing.assert_close(g, plain, atol=ATOL, rtol=0)
        torch.testing.assert_close(g.double(), ref, atol=ATOL, rtol=0)


def _bf16_gate(out, grads, qkv, reference):
    q, k, v, do = qkv
    ins = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v)]
    flash_out = flash_attention(*ins)
    flash_out.backward(torch.from_numpy(do).bfloat16())
    flash_grads = [t.grad.float() for t in ins]
    pairs = [(out, flash_out.detach().float(), reference[0])] + list(
        zip(grads, flash_grads, reference[1]))
    for i, (got, flash, ref) in enumerate(pairs):
        d_got = (got.double() - ref).abs().max().item()
        d_flash = (flash.double() - ref).abs().max().item()
        assert d_got <= BF16_FACTOR * d_flash, (i, d_got, d_flash)


@pytest.mark.parametrize("n", [2, 4])
def test_shards_bf16_stay_near_fp64(qkv, reference, n):
    out, grads = _run_shards(qkv, n, torch.bfloat16)
    _bf16_gate(out, grads, qkv, reference)


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_match_jax_ring_and_full_attention_fp32(spawned, reference,
                                                      jax_ring, n):
    out, grads = _gathered(spawned[n], "float32")
    _fp32_gates(out, grads, jax_ring[n], reference)


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_bf16_stay_near_fp64(spawned, qkv, reference, n):
    out, grads = _gathered(spawned[n], "bfloat16")
    _bf16_gate(out, grads, qkv, reference)


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_equal_the_single_process_form(spawned, qkv, n):
    out, grads = _run_shards(qkv, n, torch.float32)
    r_out, r_grads = _gathered(spawned[n], "float32")
    torch.testing.assert_close(r_out, out, atol=1e-6, rtol=0)
    for a, b in zip(r_grads, grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_lengths_that_do_not_divide_raise_as_in_jax(qkv):
    q, k, v, _ = (torch.from_numpy(a) for a in qkv)
    with pytest.raises(AssertionError,
                       match="sequence lengths 64/48 must divide over 5 "
                             "'seq' shards"):
        ring_attention_shards(q, k, v, 5)
    mesh = JMesh(np.asarray(jax.devices()[:5]), ("seq",))
    with pytest.raises(AssertionError, match="must divide over 5 'seq'"):
        j_ring(*(jnp.asarray(a) for a in qkv[:3]), mesh)


def test_a_mesh_of_one_is_full_attention(qkv, reference):
    q, k, v, _ = (torch.from_numpy(a) for a in qkv)
    out = ring_attention(q, k, v, Mesh({"seq": 1}, "cpu"))
    torch.testing.assert_close(out.double(), reference[0], atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 4])
def test_ring_launches_the_kernels_on_the_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels run only there")
    from vqgan_tpu_torch.kernels.flash_bwd import FLASH_BWD_DKV, FLASH_BWD_DQ
    from vqgan_tpu_torch.kernels.flash_fwd import FLASH_FWD

    g = torch.Generator("cuda").manual_seed(0)
    q, k, v = (torch.randn((2, 256, 2, 64), generator=g, device="cuda",
                           dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    before = [K.launches for K in (FLASH_FWD, FLASH_BWD_DQ, FLASH_BWD_DKV)]
    ring_attention_shards(q, k, v, n).float().sum().backward()
    torch.cuda.synchronize()
    after = [K.launches for K in (FLASH_FWD, FLASH_BWD_DQ, FLASH_BWD_DKV)]
    assert [a - b for a, b in zip(after, before)] == [n * n] * 3
