"""Port parity: the flash-attention backward of vqgan_tpu_torch against
vqgan_tpu's.

On the CPU the port's backward runs the kernels' plain versions
(`flash_bwd_dq_reference`, `flash_bwd_dkv_reference`); they are held against
the JAX package's two Pallas backward kernels run in interpret mode, and the
autograd path of the port's `flash_attention` against `jax.grad` of the JAX
`flash_attention` (interpret mode) and of `sdpa_reference`. The CUDA kernels
themselves are held against the plain versions in the `gpu`-marked tests,
which need a card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.ops.attention import _flash_backward, _flash_forward
from vqgan_tpu.ops.attention import flash_attention as j_flash_attention
from vqgan_tpu.ops.attention import sdpa_reference as j_sdpa_reference
from vqgan_tpu_torch.ops import attention as port_attention
from vqgan_tpu_torch.ops.attention import (
    FlashAttentionFunction,
    flash_attention,
    flash_bwd_dkv,
    flash_bwd_dkv_reference,
    flash_bwd_dq,
    flash_bwd_dq_reference,
    flash_delta,
    flash_forward,
)

torch.set_num_threads(2)

# (B, Sq, Skv, H, D): the ragged shapes of test_torch_port_attention.py,
# the U-Net mid-block head layout included
SHAPES = [(1, 7, 7, 2, 16), (2, 100, 100, 1, 512), (2, 64, 17, 4, 32),
          (2, 16, 16, 8, 64)]
# fp32 gradients of O(1) inputs: the two sides differ only in summation
# order over at most Skv = 100 terms of O(1); measured below 5e-6
ATOL = 2e-5


def _arrays(b, s_q, s_kv, h, d, seed=0):
    """q, k, v, dO as float32 numpy, BSHD."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s_q, h, d)).astype(np.float32),
            rng.standard_normal((b, s_kv, h, d)).astype(np.float32),
            rng.standard_normal((b, s_kv, h, d)).astype(np.float32),
            rng.standard_normal((b, s_q, h, d)).astype(np.float32))


def _bhsd(x):
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _bshd(x, b, h):
    bh, s, d = x.shape
    return np.asarray(x).reshape(b, h, s, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("b,s_q,s_kv,h,d", SHAPES)
def test_plain_backward_matches_pallas_interpret(b, s_q, s_kv, h, d):
    q, k, v, do = _arrays(b, s_q, s_kv, h, d)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jdo = map(_bhsd, (q, k, v, do))
    j_out, j_lse = _flash_forward(jq, jk, jv, scale, 64, 128, True)
    j_dq, j_dk, j_dv = _flash_backward(jq, jk, jv, j_out, j_lse, jdo, scale,
                                       64, 128, True)
    # the same saved (out, lse) on both sides
    out = torch.from_numpy(_bshd(j_out, b, h).copy())
    lse = torch.from_numpy(np.asarray(j_lse).reshape(b, h, s_q).copy())
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    delta = flash_delta(out, tdo)
    assert delta.shape == (b, h, s_q) and delta.is_contiguous()
    dq = flash_bwd_dq_reference(tq, tk, tv, tdo, lse, delta, scale)
    dk, dv = flash_bwd_dkv_reference(tq, tk, tv, tdo, lse, delta, scale)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    for got, want in ((dq, j_dq), (dk, j_dk), (dv, j_dv)):
        np.testing.assert_allclose(got.numpy(), _bshd(want, b, h),
                                   atol=ATOL)
    # on CPU tensors the dispatchers are the plain versions
    torch.testing.assert_close(
        flash_bwd_dq(tq, tk, tv, tdo, lse, delta, scale), dq, rtol=0, atol=0)
    for got, want in zip(flash_bwd_dkv(tq, tk, tv, tdo, lse, delta, scale),
                         (dk, dv)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _torch_grads(q, k, v, do, **kwargs):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, **kwargs)
    return torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))


@pytest.mark.parametrize("b,s_q,s_kv,h,d", SHAPES)
def test_autograd_matches_jax_grad(b, s_q, s_kv, h, d):
    q, k, v, do = _arrays(b, s_q, s_kv, h, d, seed=1)
    grads = _torch_grads(q, k, v, do)

    def vjp_of(fn):
        _, pullback = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
        return pullback(jnp.asarray(do))

    j_flash = vjp_of(lambda q, k, v: j_flash_attention(
        q, k, v, block_q=64, block_kv=128, interpret=True))
    j_ref = vjp_of(j_sdpa_reference)
    for got, want_flash, want_ref in zip(grads, j_flash, j_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want_flash),
                                   atol=ATOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_ref),
                                   atol=ATOL)


def test_strided_cotangent_gives_the_same_gradient(monkeypatch):
    # dO arrives as the U-Net's `from_heads` leaves it: a view whose
    # head_dim axis is strided. The backward makes it contiguous before the
    # kernels (which take strided batch, sequence and head axes, but not a
    # strided last axis), and the gradient is unchanged.
    b, s, h, d = 2, 16, 8, 64
    q, k, v, do = _arrays(b, s, s, h, d, seed=2)
    seen = []
    real = port_attention.flash_bwd_dq

    def checked(q, k, v, do, lse, delta, scale=None):
        seen.append(do.stride())
        assert all(t.stride(-1) == 1 for t in (q, k, v, do))
        return real(q, k, v, do, lse, delta, scale)

    monkeypatch.setattr(port_attention, "flash_bwd_dq", checked)
    nchw = torch.from_numpy(do).reshape(b, 4, 4, h * d).permute(0, 3, 1, 2)
    strided = nchw.contiguous().permute(0, 2, 3, 1).reshape(b, s, h, d)
    assert strided.stride(-1) != 1
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv)
    got = torch.autograd.grad(out, (tq, tk, tv), strided)
    want = _torch_grads(q, k, v, do)
    assert seen and seen[0][-1] == 1
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)


def test_unet_backward_meets_the_kernel_contract(monkeypatch):
    # a training step's gradient reaches the backward kernels through the
    # U-Net's mid-block attention; every input must be one the CUDA
    # kernels take (on the CPU the plain path would not notice)
    from vqgan_tpu_torch.models import CFGUnet

    calls = []
    real = {n: getattr(port_attention, n)
            for n in ("flash_bwd_dq", "flash_bwd_dkv")}

    def checked(name):
        def fn(q, k, v, do, lse, delta, scale=None):
            calls.append((name, tuple(q.shape)))
            assert all(t.stride(-1) == 1 for t in (q, k, v, do))
            assert lse.is_contiguous() and delta.is_contiguous()
            assert lse.dtype == delta.dtype == torch.float32
            assert q.dtype == k.dtype == v.dtype == do.dtype
            return real[name](q, k, v, do, lse, delta, scale)
        return fn

    for name in real:
        monkeypatch.setattr(port_attention, name, checked(name))
    torch.manual_seed(0)
    net = CFGUnet(dim=16, num_classes=3, cond_drop_prob=0.0,
                  dim_mults=(1, 2), channels=4, attn_dim_head=16,
                  attn_heads=2, dtype=torch.bfloat16)
    out = net(torch.randn(2, 4, 8, 8), torch.tensor([3, 7]),
              torch.tensor([0, 2]), cond_drop_mask=torch.tensor([False, True]))
    out.square().mean().backward()
    assert calls == [("flash_bwd_dq", (2, 16, 2, 16)),
                     ("flash_bwd_dkv", (2, 16, 2, 16))]
    assert net.mid_attn.fn.fn.to_qkv.weight.grad is not None


@pytest.mark.parametrize("model", ["vqvae", "klvae"])
def test_vae_attention_meets_the_kernel_layout(monkeypatch, model):
    # a training step of the VQ-VAE (bf16, as VQ-GAN training runs it) or
    # the KL-VAE (fp32) reaches the flash kernels from its level and mid
    # attention blocks, forward and backward; every q, k, v and dO must be
    # one the tensor-core kernels stage with 16-byte copies: last axis
    # contiguous, base and the stride of every axis longer than 1 a multiple
    # of 16 bytes (on the CPU the plain path would not notice; on the card
    # the entry points refuse anything else)
    from vqgan_tpu_torch.models import KLVAE, VQVAE
    from vqgan_tpu_torch.models.autoencoder import AutoencoderConfig

    calls = []
    real = {n: getattr(port_attention, n)
            for n in ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")}

    def checked(name, n_inputs):
        def fn(*args):
            inputs = args[:n_inputs]
            calls.append(name)
            for t in inputs:
                size = t.element_size()
                assert t.stride(-1) == 1 and t.data_ptr() % 16 == 0
                assert all(n == 1 or s * size % 16 == 0 for n, s in
                           zip(t.shape[:-1], t.stride()[:-1])), t.stride()
            assert len({t.dtype for t in inputs}) == 1
            return real[name](*args)
        return fn

    for name, n_inputs in (("flash_forward", 3), ("flash_bwd_dq", 4),
                           ("flash_bwd_dkv", 4)):
        monkeypatch.setattr(port_attention, name, checked(name, n_inputs))
    torch.manual_seed(0)
    if model == "vqvae":
        net = VQVAE(ch=16, ch_mult=(1, 2), num_res_blocks=1, resolution=32,
                    z_channels=16, num_embeddings=8, embedding_dim=16,
                    dtype=torch.bfloat16)
        recon, _, _ = net(torch.rand(2, 3, 32, 32))
        # the straight-through quantizer passes this to the encoder too
        loss = recon.float().square().mean()
    else:
        net = KLVAE(AutoencoderConfig(ch=32, ch_mult=(1, 2),
                                      num_res_blocks=1, attn_resolutions=(8,),
                                      resolution=16))
        recon, posterior = net(torch.rand(2, 3, 16, 16),
                               generator=torch.Generator().manual_seed(0))
        loss = recon.square().mean() + posterior.kl().mean()
    loss.backward()
    # 5 attention blocks (1 in the encoder's level, 2 in the decoder's, the
    # two mid blocks), each once forward and once backward
    assert calls.count("flash_forward") == 5
    assert calls.count("flash_bwd_dq") == calls.count("flash_bwd_dkv") == 5


def test_no_gradient_wanted_saves_nothing(monkeypatch):
    # generation runs under inference_mode: the forward alone, no autograd
    # Function, so nothing is saved and no backward kernel can run
    applied = []
    real_apply = FlashAttentionFunction.apply
    monkeypatch.setattr(FlashAttentionFunction, "apply",
                        lambda *a: applied.append(1) or real_apply(*a))
    from vqgan_tpu_torch.diffusion import GaussianDiffusion
    from vqgan_tpu_torch.models import CFGUnet

    torch.manual_seed(0)
    net = CFGUnet(dim=16, num_classes=3, cond_drop_prob=0.0,
                  dim_mults=(1, 2), channels=4, attn_dim_head=16,
                  attn_heads=2)
    diffusion = GaussianDiffusion(net, image_size=8, channels=4,
                                  timesteps=20, sampling_timesteps=2,
                                  objective="pred_v", auto_normalize=False,
                                  device="cpu")
    z = diffusion.sample(classes=torch.tensor([0, 1]), cond_scale=3.0,
                         generator=torch.Generator().manual_seed(0))
    assert z.shape == (2, 8, 8, 4) and not z.requires_grad
    assert applied == []
    q, k, v, _ = (torch.from_numpy(a).requires_grad_()
                  for a in _arrays(1, 8, 8, 1, 16))
    with torch.inference_mode():
        out = flash_attention(q, k, v)
    assert out.grad_fn is None and applied == []
    out = flash_attention(q, k, v)  # a gradient is wanted here
    assert out.grad_fn is not None and applied == [1]


def test_backward_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    from vqgan_tpu_torch.kernels.flash_bwd import (
        flash_bwd_dkv as dkv_kernel,
        flash_bwd_dq as dq_kernel,
    )

    q, k, v, do = map(torch.from_numpy, _arrays(1, 8, 8, 1, 16))
    out, lse = flash_forward(q, k, v)
    delta = flash_delta(out, do)
    for kernel in (dq_kernel, dkv_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            kernel(q, k, v, do, lse, delta, 0.25)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_bwd_dq(*(t.to("meta") for t in (q, k, v, do, lse, delta)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the backward kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s_q,s_kv,h,d",
                         SHAPES + [(8, 16, 16, 8, 64), (2, 1024, 1024, 1, 512),
                                   (8, 1024, 1024, 1, 512)])
def test_backward_kernels_match_plain_on_gpu(cuda_device, b, s_q, s_kv, h, d,
                                             dtype):
    from vqgan_tpu_torch.kernels.flash_bwd import (
        FLASH_BWD_DKV,
        FLASH_BWD_DQ,
        flash_bwd_dkv as dkv_kernel,
        flash_bwd_dq as dq_kernel,
    )

    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(cuda_device, dt)
                   for a in _arrays(b, s_q, s_kv, h, d, seed=4))
    do = torch.cat([do, do], dim=-1)[..., :d]  # strided sequence axis
    scale = 1.0 / math.sqrt(d)
    out, lse = flash_forward(q, k, v, scale)
    delta = flash_delta(out, do)
    before = FLASH_BWD_DQ.launches, FLASH_BWD_DKV.launches
    dq = dq_kernel(q, k, v, do, lse, delta, scale)
    dk, dv = dkv_kernel(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert (FLASH_BWD_DQ.launches, FLASH_BWD_DKV.launches) == (
        before[0] + 1, before[1] + 1)
    want = (flash_bwd_dq_reference(q, k, v, do, lse, delta, scale),
            *flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale))
    # the same fp32 math in another order; bf16 outputs round once (8 bits)
    rel = 2e-5 if dtype == "float32" else 1e-2
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dt
        size = max(ref.float().abs().max().item(), 1.0)
        torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                   atol=rel * size)
    if (b, s_q, h, d, dtype) == (8, 1024, 1, 512, "bfloat16"):
        # the VQ-VAE's training shape: dK and dV within 2e-3 of their
        # largest plain value (rounding flips only below about a quarter of
        # it), or, where the plain fp32 version is itself farther than that
        # from an fp64 evaluation of the same math, no farther from it than
        # the plain version; each element is summed in one fixed order, so
        # a second run is equal bit for bit
        qs = q.double() * scale
        p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qs, k.double())
                      - lse.double()[..., None])
        dp = torch.einsum("bqhd,bkhd->bhqk", do.double(), v.double())
        exact = (torch.einsum("bhqk,bqhd->bkhd",
                              p * (dp - delta.double()[..., None]), qs),
                 torch.einsum("bhqk,bqhd->bkhd", p, do.double()))
        for got, ref, ex in zip((dk, dv), want[1:], exact):
            rule = 2e-3 * ref.float().abs().max().item()
            ex = ex.to(dt).float()
            plain_off = (ref.float() - ex).abs().max().item()
            got_off = (got.float() - ex).abs().max().item()
            err = (got.float() - ref.float()).abs().max().item()
            assert err <= rule or (plain_off > rule and got_off <= plain_off)
        again = dkv_kernel(q, k, v, do, lse, delta, scale)
        assert torch.equal(again[0], dk) and torch.equal(again[1], dv)
