"""The port's FLOP accounting (`vqgan_tpu_torch/utils/flops.py`) held to
the JAX package's (`vqgan_tpu/utils/flops.py`, XLA's cost analysis of the
lowered program, and the kernels' `pl.CostEstimate`).

- The peak table by the card's name.
- A dense layer and convolutions (VALID, SAME, strided, transposed, and
  their gradients) count exactly what `lowered_flops` counts: XLA counts a
  convolution's in-image taps, and so does the port.
- Whole small models (the widths of `test_torch_port_generate.py` and
  `test_torch_port_vqvae.py`) within a stated tolerance of JAX's count.
- The four operators count by their formulas, once each, equal to JAX's
  CostEstimate (forward, VQ) and to the counter's count of their plain
  versions (all four).
- Fake counting equals real counting; bytes follow the lower-bound rule.
- `scan_corrected_flops`, `mfu`, `flops_report` and the roofline record
  keep the JAX package's contract (`tests/test_profiling.py`).
- The smoke's bounds of PERF.md's kernel table follow from the formulas.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vqgan_tpu.models import CFGUnet as JCFGUnet
from vqgan_tpu.models import KLVAE as JKLVAE
from vqgan_tpu.models import VQVAE as JVQVAE
from vqgan_tpu.models.autoencoder import AutoencoderConfig as JConfig
from vqgan_tpu.ops.attention import flash_attention as j_flash_attention
from vqgan_tpu.ops.vq import vq_lookup as j_vq_lookup
from vqgan_tpu.utils.flops import lowered_flops
from vqgan_tpu.utils.flops import scan_corrected_flops as j_scan_corrected
from vqgan_tpu_torch.kernels.ops import OPS
from vqgan_tpu_torch.models import KLVAE, VQVAE, CFGUnet
from vqgan_tpu_torch.models.autoencoder import AutoencoderConfig
from vqgan_tpu_torch.ops.attention import (
    flash_attention,
    flash_bwd_dkv_reference,
    flash_bwd_dq_reference,
    flash_forward_reference,
)
from vqgan_tpu_torch.ops.vq import vq_lookup_reference
from vqgan_tpu_torch.utils import flops as fl

torch.set_num_threads(2)

H100 = "NVIDIA H100 80GB HBM3"
UNET = dict(dim=16, num_classes=3, cond_drop_prob=0.0, dim_mults=(1, 2),
            channels=4, attn_dim_head=16, attn_heads=2)
VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
           resolution=16, z_channels=4)
VQ = dict(ch=16, ch_mult=(1, 2), num_res_blocks=1, resolution=32,
          z_channels=16, num_embeddings=8, embedding_dim=16)
# XLA counts one FLOP per element of every elementwise operation (norms,
# activations, residual and bias adds, the losses); the port's counter
# counts none, so a whole model reads below JAX. At these narrow widths
# those operations are 1.6-3.2% of JAX's count (U-Net 0.968, KL-VAE decode
# 0.984, VQ-VAE 0.969); never above it, since every product is counted
# alike.
MODEL_RATIO = (0.95, 1.0)


@pytest.fixture
def card(monkeypatch):
    """Pretend the current CUDA device is named `name`."""
    def set_name(name):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda *args: name)
    return set_name


@pytest.mark.parametrize("name,want", [(H100, 989.0),
                                       ("NVIDIA H200", 989.0),
                                       ("NVIDIA A100-SXM4-80GB", None)])
def test_peak_tflops_by_the_cards_name(card, name, want):
    card(name)
    assert fl.peak_tflops() == want
    assert fl.peak_tflops(torch.device("cuda", 0)) == want
    assert fl.peak_tflops(torch.device("cpu")) is None
    peaks = fl.peaks_for(name)
    assert (peaks is None) == (want is None)
    if peaks:
        assert peaks["float32"] == pytest.approx(165e12)


def test_peak_tflops_is_none_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert fl.peak_tflops() is None
    assert fl.mfu(1e12, 1.0) is None


def _jconv(x, w, stride, pad):
    return jax.lax.conv_general_dilated(
        x, w, (stride, stride), pad, dimension_numbers=("NHWC", "HWIO",
                                                        "NHWC"))


def test_dense_layer_equals_jax():
    x, w = np.ones((8, 48), np.float32), np.ones((48, 24), np.float32)
    want = lowered_flops(jnp.dot, x, w)
    got = fl.count_flops(torch.matmul, torch.from_numpy(x),
                         torch.from_numpy(w))
    assert got == want == 2 * 8 * 48 * 24


# (batch, size, c_in, c_out, kernel, stride, padding)
CONVS = {
    "valid_3x3": (2, 32, 64, 128, 3, 1, 0),
    "same_3x3": (2, 32, 64, 128, 3, 1, 1),
    "stride2_3x3_odd": (2, 33, 8, 16, 3, 2, 1),
    "stride2_4x4": (2, 32, 8, 16, 4, 2, 1),
}


@pytest.mark.parametrize("case", list(CONVS))
def test_convolution_and_its_gradients_equal_jax(case):
    n, h, ci, co, k, s, p = CONVS[case]
    x, w = jnp.ones((n, h, h, ci)), jnp.ones((k, k, ci, co))
    pad = ((p, p), (p, p))
    j_fwd = lowered_flops(lambda x, w: _jconv(x, w, s, pad), x, w)
    j_both = lowered_flops(jax.grad(lambda x, w: _jconv(x, w, s, pad).sum(),
                                    argnums=(0, 1)), x, w)
    j_weight = lowered_flops(jax.grad(
        lambda x, w: _jconv(x, w, s, pad).sum(), argnums=1), x, w)

    tw = torch.ones(co, ci, k, k, requires_grad=True)

    def fwd(x):
        return F.conv2d(x, tw, stride=s, padding=p)

    def fwd_bwd(x):
        fwd(x).sum().backward()

    x_grad = torch.ones(n, ci, h, h, requires_grad=True)
    x_data = torch.ones(n, ci, h, h)
    t_fwd = fl.count_flops(fwd, x_data)
    assert t_fwd == j_fwd
    # a forward + backward counts the forward once more than JAX's grad,
    # whose forward output is unused and dropped
    assert fl.count_flops(fwd_bwd, x_grad, fake=False) - t_fwd == j_both
    assert fl.count_flops(fwd_bwd, x_data, fake=False) - t_fwd == j_weight
    if case == "same_3x3":
        assert t_fwd == 289_538_048
        stock = torch.utils.flop_counter.FlopCounterMode(display=False)
        with stock:
            fwd(x_data)
        assert stock.get_total_flops() == 301_989_888  # every tap


def test_transposed_convolution_equals_jax():
    # the KL-VAE's UpsampleTranspose: k4 s2, JAX's padding "SAME"
    m = nn.ConvTranspose(16, (4, 4), strides=(2, 2), padding="SAME",
                         use_bias=False)
    x = jnp.ones((2, 8, 8, 8))
    params = m.init(jax.random.PRNGKey(0), x)
    j_fwd = lowered_flops(lambda p, x: m.apply(p, x), params, x)
    j_both = lowered_flops(jax.grad(lambda p, x: m.apply(p, x).sum(),
                                    argnums=(0, 1)), params, x)
    tx = torch.ones(2, 8, 8, 8, requires_grad=True)
    tw = torch.ones(8, 16, 4, 4, requires_grad=True)

    def fwd():
        return F.conv_transpose2d(tx, tw, stride=2, padding=1)

    def fwd_bwd():
        fwd().sum().backward()

    assert fwd().shape == (2, 16, 16, 16)
    t_fwd = fl.count_flops(fwd)
    assert t_fwd == j_fwd
    assert fl.count_flops(fwd_bwd, fake=False) - t_fwd == j_both


def _ratio(got, want):
    lo, hi = MODEL_RATIO
    assert lo <= got / want <= hi, (got, want, got / want)


def test_cfg_unet_forward_within_tolerance_of_jax():
    b = 3
    jnet = JCFGUnet(**UNET)
    x, t = jnp.zeros((b, 8, 8, 4)), jnp.zeros((b,), jnp.int32)
    mask = jnp.zeros((b,), bool)
    params = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x, t, t,
                            cond_drop_mask=mask)
    params = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), params)
    want = lowered_flops(lambda p, x, t: jnet.apply(p, x, t, t,
                                                    cond_drop_mask=mask),
                         params, x, t)
    net = CFGUnet(**UNET).eval()
    zeros = torch.zeros(b, dtype=torch.long)
    with torch.no_grad():
        got = fl.count_flops(net, torch.zeros(b, 4, 8, 8), zeros, zeros)
    _ratio(got, want)


def test_kl_vae_decode_within_tolerance_of_jax():
    jvae = JKLVAE(config=JConfig(**VAE))
    params = jvae.init({"params": jax.random.PRNGKey(1),
                        "gaussian": jax.random.PRNGKey(2)},
                       jnp.zeros((1, 16, 16, 3)))
    z = jnp.zeros((3, 8, 8, 4))
    want = lowered_flops(
        lambda p, z: jvae.apply(p, z, method=JKLVAE.decode_latents),
        params, z)
    vae = KLVAE(AutoencoderConfig(**VAE)).eval()
    with torch.no_grad():
        got = fl.count_flops(vae.decode_latents, torch.zeros(3, 8, 8, 4))
    _ratio(got, want)


def test_vqvae_forward_within_tolerance_of_jax():
    jnet = JVQVAE(**VQ)
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    images = np.random.default_rng(0).random((2, 32, 32, 3)).astype(
        np.float32)
    want = lowered_flops(lambda p, x: jnet.apply(p, x), params, images)
    net = VQVAE(**VQ)
    got = fl.count_flops(net, torch.from_numpy(images).permute(0, 3, 1, 2))
    _ratio(got, want)


def _cost_estimates(fn, *args):
    """The `pl.CostEstimate` of every pallas_call in fn's jaxpr (None for
    a call without one)."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                found.append(eqn.params.get("cost_estimate"))
            for param in eqn.params.values():
                inner = getattr(param, "jaxpr", None)
                if inner is not None:
                    walk(getattr(inner, "jaxpr", inner))

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def _attention_inputs(b=2, s=128, h=2, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(4)]


def test_flash_forward_count_equals_jax_cost_estimate():
    q, k, v, _ = _attention_inputs()  # S = 128: no padding in JAX
    (est,) = _cost_estimates(lambda q, k, v: j_flash_attention(q, k, v),
                             q, k, v)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = fl.count_flops(OPS["flash_fwd"], tq, tk, tv, 0.125)
    assert got == est.flops == 4 * 2 * 2 * 128 * 128 * 64
    # the plain version's products count the same
    assert fl.count_flops(flash_forward_reference, tq, tk, tv, 0.125) == got


def test_flash_backward_counts_the_formulas_jax_counts_none():
    q, k, v, do = _attention_inputs()
    ests = _cost_estimates(jax.grad(
        lambda q: j_flash_attention(q, k, v).sum()), q)
    assert ests[1:] == [None, None]  # XLA counts JAX's backward as zero
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    lse = torch.zeros(2, 2, 128)
    args = (tq, tk, tv, tdo, lse, lse, 0.125)
    base = 2 * 2 * 128 * 128 * 64
    assert fl.count_flops(OPS["flash_bwd_dq"], *args) == 6 * base
    assert fl.count_flops(OPS["flash_bwd_dkv"], *args) == 8 * base
    assert fl.count_flops(flash_bwd_dq_reference, *args) == 6 * base
    assert fl.count_flops(flash_bwd_dkv_reference, *args) == 8 * base
    work = fl.backward_work(2, 128, 128, 2, 64, 4)
    assert work["flash_bwd_dq"][1] == 6 * base
    assert work["flash_bwd_dkv"][1] == 8 * base


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_vq_count_equals_jax_cost_estimate(mode):
    rng = np.random.default_rng(1)
    z = rng.standard_normal((512, 64)).astype(np.float32)
    cb = rng.standard_normal((256, 64)).astype(np.float32)
    (est,) = _cost_estimates(
        lambda z, cb: j_vq_lookup(z, cb, "fp32" if mode == "fp32" else True),
        z, cb)
    tz, tcb = torch.from_numpy(z), torch.from_numpy(cb)
    got = fl.count_flops(OPS["vq_nearest"], tz, tcb, mode)
    assert got == est.flops == 2 * 512 * 256 * 64 == fl.vq_work(
        512, 256, 64)[1]
    assert fl.count_flops(vq_lookup_reference, tz, tcb, mode) == got


@pytest.mark.parametrize("fake", [True, False])
def test_an_operator_is_one_leaf_and_the_backward_counts_both_kernels(fake):
    # the CPU implementations are einsums; under the counter each operator
    # is one leaf counted by its formula, not formula + its own products
    q = torch.randn(2, 32, 2, 16, requires_grad=True)
    base = 2 * 2 * 32 * 32 * 16

    def fwd_bwd(q):
        out = flash_attention(q, q, q)
        out.sum().backward()
        return out

    q.grad = None
    assert fl.count_flops(flash_attention, q.detach(), q.detach(),
                          q.detach(), fake=fake) == 4 * base
    if not fake:  # fake tensors would land in the real leaf's .grad
        assert fl.count_flops(fwd_bwd, q, fake=False) == 18 * base


def test_fake_counting_equals_real_counting():
    net = CFGUnet(**UNET).eval()
    zeros = torch.zeros(3, dtype=torch.long)
    x = torch.randn(3, 4, 8, 8)
    with torch.no_grad():
        fake = fl.count_work(net, x, zeros, zeros)
        real = fl.count_work(net, x, zeros, zeros, fake=False)
    assert fake == real and fake[0] > 0 and fake[1] > 0
    z = torch.randn(256, 16)
    cb = torch.randn(64, 16)
    assert fl.count_work(OPS["vq_nearest"], z, cb, "fp32") == fl.count_work(
        OPS["vq_nearest"], z, cb, "fp32", fake=False)


def test_bytes_count_each_input_read_once_and_each_output_written_once():
    q, k, v, _ = (torch.from_numpy(a) for a in _attention_inputs(
        b=1, s=64, h=2, d=32))
    n_bytes = fl.count_bytes(OPS["flash_fwd"], q, k, v, 0.25)
    assert n_bytes == fl.flash_fwd_work(1, 64, 64, 2, 32, 4)[0]
    # a view read twice is one read of its storage
    assert fl.count_bytes(lambda x: x[:, :32] + x[:, 32:], q) == (
        q.numel() * 4 + q.numel() * 2)

    # a training step: the parameters and Adam's two moments read and
    # written, the batch read; the gradients, made inside, count nothing
    lin = torch.nn.Linear(16, 4)
    opt = torch.optim.Adam(lin.parameters())
    batch = torch.randn(8, 16)

    def step():
        opt.zero_grad()
        lin(batch).pow(2).sum().backward()
        opt.step()

    step()  # the moments exist from here
    p_bytes = sum(p.numel() * 4 for p in lin.parameters())
    steps = sum(s["step"].numel() * s["step"].element_size()
                for s in opt.state.values())
    want = 2 * 3 * p_bytes + 2 * steps + batch.numel() * 4
    assert fl.count_bytes(step, fake=False) == want


def _inference(fn):
    with torch.inference_mode():
        return fn()


@pytest.mark.parametrize("fake", [True, False])
@pytest.mark.parametrize("program, want", [
    # a slice reads the span it covers, not its whole storage
    (lambda d, x: x[:, :32] * 2, 2 + 2),
    # two views of one storage merge into one read of the whole
    (lambda d, x: x[:, :32] + x[:, 32:], 4 + 2),
    # an overwrite's target and an out= argument are written, not read
    (lambda d, x: d.copy_(x), 4 + 4),
    (lambda d, x: torch.add(x, 1, out=d), 4 + 4),
    # an update in place reads and writes its target
    (lambda d, x: d.add_(x), 4 + 4 + 4),
    # under inference mode `to` reaches the counter whole: a cast is a
    # copy, made by the program (its input read once, the bf16 result
    # written once); a `to` that returns its input moves nothing
    (lambda d, x: _inference(lambda: x.to(torch.bfloat16) * 2), 4 + 2),
    (lambda d, x: _inference(lambda: x.to(torch.float32) * 2), 4 + 4),
], ids=["slice", "two_views", "copy_", "out=", "add_", "cast", "no_cast"])
def test_bytes_count_the_span_a_view_covers_and_no_read_of_an_overwrite(
        program, want, fake):
    x = torch.randn(1, 64, 2, 32)
    d = torch.empty_like(x)
    # want: bytes in units of x.numel() (fp32: 4 bytes an element)
    assert fl.count_bytes(program, d, x, fake=fake) == want * x.numel()


def test_an_eager_loop_counts_its_trips_and_scan_correction_keeps_jax():
    w = torch.randn(64, 64)

    def body(c):
        return torch.tanh(c @ w)

    def loop(c):
        for _ in range(10):
            c = body(c)
        return c

    x = torch.randn(64, 64)
    one = fl.count_flops(body, x)
    assert one == 2 * 64 ** 3
    assert fl.count_flops(loop, x) == 10 * one
    # a captured loop: its eager body times the trips, which is JAX's
    # correction with the program counted as one body
    assert fl.scan_corrected_flops(one, one, 10) == 10 * one
    for args in ((one, one, 10), (3.0 * one, one, 7), (None, one, 10),
                 (one, None, 10)):
        assert fl.scan_corrected_flops(*args) == j_scan_corrected(*args)


def test_mfu_and_flops_report_keep_the_jax_contract(card):
    card(H100)
    assert fl.mfu(989e12 * 0.25, 1.0) == pytest.approx(0.25)
    assert fl.mfu(None, 1.0) is None and fl.mfu(1e12, 0.0) is None
    rep = fl.flops_report(1e12, 0.01)
    assert rep == {"flops_per_step": 1e12, "tflops_per_sec": 100.0,
                   "mfu": round(1e12 / 0.01 / 989e12, 4)}
    assert fl.flops_report(None, 0.01) == {"flops_per_step": None,
                                           "mfu": None}
    # fp32 programs: MFU stays against the bf16 peak, as in JAX
    cpu = fl.flops_report(1e12, 0.01, device=torch.device("cpu"))
    assert cpu == {"flops_per_step": 1e12, "tflops_per_sec": 100.0,
                   "mfu": None}


def test_roofline_record(card):
    card(H100)
    rec = fl.roofline("toy", 1e12, 1e6, 0.01, 8)
    assert rec["program"] == "toy" and rec["items_per_sec"] == 800.0
    assert rec["t_tensor_core_ms"] == round(1e12 / 989e12 * 1e3, 5)
    assert rec["t_hbm_ms"] == round(1e6 / 3.35e12 * 1e3, 5)
    assert rec["bound"] == "tensor_core"
    assert rec["roofline_fraction"] == pytest.approx(1e12 / 989e12 / 0.01,
                                                     abs=1e-6)
    assert rec["arith_intensity_flops_per_byte"] == 1e6
    assert rec["mfu"] == pytest.approx(0.1011, abs=1e-4)
    fp32 = fl.roofline("toy", 1e12, 1e6, 0.01, 8, dtype="float32")
    assert fp32["t_tensor_core_ms"] == round(1e12 / 165e12 * 1e3, 5)
    assert fp32["mfu"] == rec["mfu"]  # against the bf16 peak either way
    mem = fl.roofline("copy", 1e3, 1e10, 0.01, 1)
    assert mem["bound"] == "hbm"
    cpu = fl.roofline("toy", 1e12, 1e6, 0.01, 8, device=torch.device("cpu"))
    assert cpu["mfu"] is None and cpu["t_tensor_core_ms"] is None
    assert "bound" not in cpu and "roofline_fraction" not in cpu


@pytest.mark.parametrize("work,dtype,want_ms,want_by", [
    # the VQ search at the JAX package's bench shape [8192,256]x[8192,256]
    (fl.vq_work(8192, 8192, 256), "float32", 0.2082, "operations"),
    # the U-Net's mid attention in generation, [16,16,8,64] bf16
    (fl.flash_fwd_work(16, 16, 16, 8, 64, 2), "bfloat16", 0.000315,
     "bytes"),
    # the KL-VAE's in training, forward, [8,1024,1,512] fp32
    (fl.flash_fwd_work(8, 1024, 1024, 1, 512, 4), "float32", 0.1041,
     "operations"),
])
def test_the_kernel_tables_bounds_follow_from_the_formulas(work, dtype,
                                                           want_ms,
                                                           want_by):
    ms, by = fl.bound(fl.PEAKS["H100"], *work, dtype)
    assert by == want_by
    assert ms == pytest.approx(want_ms, rel=2e-3)
