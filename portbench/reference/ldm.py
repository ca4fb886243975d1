"""The class-conditional latent diffusion model in plain float32: the CFG
U-Net (lucidrains' `classifier_free_guidance.Unet` as the reference
repository's `train_latent_cfg.py` configures it), the cosine schedule,
the pred_v loss with min-SNR weighting, clipped AdamW with the EMA of
ema_pytorch, the DDIM sampler and the KL-VAE decoder.

U-Net, NCHW: a sinusoidal time embedding and a class embedding, each
through Linear-GELU(tanh)-Linear to 4 dim, concatenated as every ResNet
block's conditioning (a FiLM scale and shift from SiLU + Linear); blocks
of conv3x3, channel RMSNorm (x / |x| sqrt(C) g), FiLM, SiLU; per level two
blocks, a pre-normed residual linear attention (4 heads of 32: softmax of
q over features, of k over positions), a pre-normed residual cross
attention to the one class token (softmax over one key is 1, so it adds
to_out(to_v(c)) at every position), and a 4x4 stride-2 convolution down
or a nearest 2x upsample and conv3x3 up; a middle of block, full
attention (8 heads of 64), cross attention, block; skips concatenated on
the way up. Weight names are the reference PyTorch model's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import autoencoder as ae
from .layers import (
    Precision,
    adam_update,
    conv2d,
    linear,
    matmul,
    rms_norm,
    single_head_attention,
)

__all__ = ["unet_spec", "klvae_spec", "unet_forward", "Schedule",
           "draw_step_noise",
           "LDMReference", "ddim_request", "klvae_decode",
           "unet_step_flops", "request_flops"]


# --- weights ---------------------------------------------------------------

def _lin(spec, name, c_in, c_out, bias=True):
    spec[f"{name}.weight"] = ((c_out, c_in), "fan_in")
    if bias:
        spec[f"{name}.bias"] = ((c_out,), "bias")


def _conv(spec, name, c_in, c_out, k, bias=True):
    spec[f"{name}.weight"] = ((c_out, c_in, k, k), "fan_in")
    if bias:
        spec[f"{name}.bias"] = ((c_out,), "bias")


def _g(spec, name, c):
    spec[f"{name}.g"] = ((1, c, 1, 1), "gain")


def _resnet(spec, name, c_in, c_out, cond):
    _lin(spec, f"{name}.mlp.1", cond, 2 * c_out)
    _conv(spec, f"{name}.block1.proj", c_in, c_out, 3)
    _g(spec, f"{name}.block1.norm", c_out)
    _conv(spec, f"{name}.block2.proj", c_out, c_out, 3)
    _g(spec, f"{name}.block2.norm", c_out)
    if c_in != c_out:
        _conv(spec, f"{name}.res_conv", c_in, c_out, 1)


def _linear_attn(spec, name, c):
    _g(spec, f"{name}.fn.norm", c)
    _conv(spec, f"{name}.fn.fn.to_qkv", c, 3 * 128, 1, bias=False)
    _conv(spec, f"{name}.fn.fn.to_out.0", 128, c, 1)
    _g(spec, f"{name}.fn.fn.to_out.1", c)


def _cross(spec, name, c, context, hidden):
    _g(spec, f"{name}.fn.norm", c)
    _conv(spec, f"{name}.fn.fn.to_q", c, hidden, 1, bias=False)
    _lin(spec, f"{name}.fn.fn.to_k", context, hidden, bias=False)
    _lin(spec, f"{name}.fn.fn.to_v", context, hidden, bias=False)
    _conv(spec, f"{name}.fn.fn.to_out", hidden, c, 1)


def _levels(cfg):
    dim = cfg["dim"]
    dims = [dim, *(dim * m for m in cfg["dim_mults"])]
    return list(zip(dims[:-1], dims[1:]))


def unet_spec(cfg: dict) -> dict:
    """{name: (shape, kind)} of the CFG U-Net of an LDM configuration."""
    dim, c = cfg["dim"], cfg["latent_channels"]
    cond, tdim = 8 * dim, 4 * dim
    hidden = cfg["attn_heads"] * cfg["attn_dim_head"]
    spec = {"classes_emb.weight": ((cfg["num_users"], dim), "embedding"),
            "null_classes_emb": ((dim,), "embedding")}
    _lin(spec, "classes_mlp.0", dim, tdim)
    _lin(spec, "classes_mlp.2", tdim, tdim)
    _lin(spec, "time_mlp.1", dim, tdim)
    _lin(spec, "time_mlp.3", tdim, tdim)
    _conv(spec, "init_conv", c, dim, 7)
    levels = _levels(cfg)
    for i, (d_in, d_out) in enumerate(levels):
        p = f"downs.{i}"
        _resnet(spec, f"{p}.0", d_in, d_in, cond)
        _resnet(spec, f"{p}.1", d_in, d_in, cond)
        _linear_attn(spec, f"{p}.2", d_in)
        _cross(spec, f"{p}.3", d_in, tdim, hidden)
        _conv(spec, f"{p}.4", d_in, d_out,
              3 if i == len(levels) - 1 else 4)
    mid = levels[-1][1]
    _resnet(spec, "mid_block1", mid, mid, cond)
    _g(spec, "mid_attn.fn.norm", mid)
    _conv(spec, "mid_attn.fn.fn.to_qkv", mid, 3 * hidden, 1, bias=False)
    _conv(spec, "mid_attn.fn.fn.to_out", hidden, mid, 1)
    _cross(spec, "mid_cross_attn", mid, tdim, hidden)
    _resnet(spec, "mid_block2", mid, mid, cond)
    for i, (d_in, d_out) in enumerate(reversed(levels)):
        p = f"ups.{i}"
        _resnet(spec, f"{p}.0", d_out + d_in, d_out, cond)
        _resnet(spec, f"{p}.1", d_out + d_in, d_out, cond)
        _linear_attn(spec, f"{p}.2", d_out)
        _cross(spec, f"{p}.3", d_out, tdim, hidden)
        if i == len(levels) - 1:
            _conv(spec, f"{p}.4", d_out, d_in, 3)
        else:
            _conv(spec, f"{p}.4.1", d_out, d_in, 3)
    _resnet(spec, "final_res_block", 2 * dim, dim, cond)
    _conv(spec, "final_conv", dim, c, 1)
    return spec


def vae_trunk(cfg: dict) -> dict:
    vae = cfg["vae"]
    return {"ch": vae["ch"], "ch_mult": vae["ch_mult"],
            "num_res_blocks": vae["num_res_blocks"],
            "attn_resolutions": vae["attn_resolutions"],
            "resolution": cfg["image_size"],
            "z_channels": cfg["latent_channels"], "in_channels": 3,
            "out_channels": 3}


def klvae_spec(cfg: dict) -> dict:
    """{name: (shape, kind)} of the KL-VAE (encoder with a doubled z,
    decoder, quant_conv, post_quant_conv)."""
    trunk = vae_trunk(cfg)
    z = trunk["z_channels"]
    spec = ae.trunk_spec(trunk, double_z=True)
    _conv(spec, "quant_conv", 2 * z, 2 * z, 1)
    _conv(spec, "post_quant_conv", z, z, 1)
    return spec


# --- the U-Net ---------------------------------------------------------------

def _time_embedding(t, dim):
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000) / (half - 1)))
    emb = t.float()[:, None] * freqs[None, :]
    return torch.cat([emb.sin(), emb.cos()], dim=-1)


def _mlp(W, name, x, pr, first, second):
    h = linear(x, W[f"{name}.{first}.weight"], W[f"{name}.{first}.bias"], pr)
    h = F.gelu(h, approximate="tanh")
    return linear(h, W[f"{name}.{second}.weight"], W[f"{name}.{second}.bias"],
                  pr)


def _c(W, name, x, pr, stride=1, padding=0):
    return conv2d(x, W[f"{name}.weight"], W.get(f"{name}.bias"), pr,
                  stride=stride, padding=padding)


def _block(W, name, x, pr, scale_shift=None):
    x = rms_norm(_c(W, f"{name}.proj", x, pr, padding=1), W[f"{name}.norm.g"])
    if scale_shift is not None:
        scale, shift = scale_shift
        x = x * (scale + 1.0) + shift
    return F.silu(x)


def _resnet_fwd(W, name, x, cond, pr):
    ss = linear(F.silu(cond), W[f"{name}.mlp.1.weight"],
                W[f"{name}.mlp.1.bias"], pr)[:, :, None, None].chunk(2, dim=1)
    h = _block(W, f"{name}.block2", _block(W, f"{name}.block1", x, pr, ss), pr)
    if f"{name}.res_conv.weight" in W:
        x = _c(W, f"{name}.res_conv", x, pr)
    return x + h


def _linear_attn_fwd(W, name, x, pr):
    b, _, h, w = x.shape
    xn = rms_norm(x, W[f"{name}.fn.norm.g"])
    qkv = _c(W, f"{name}.fn.fn.to_qkv", xn, pr)
    q, k, v = (t.reshape(b, 4, 32, h * w) for t in qkv.chunk(3, dim=1))
    q = torch.softmax(q, dim=-2) * 32 ** -0.5
    k = torch.softmax(k, dim=-1)
    context = matmul(k, v.transpose(-1, -2), pr)          # [b, h, d, e]
    out = matmul(context.transpose(-1, -2), q, pr)        # [b, h, e, n]
    out = out.reshape(b, 128, h, w)
    out = rms_norm(_c(W, f"{name}.fn.fn.to_out.0", out, pr),
                   W[f"{name}.fn.fn.to_out.1.g"])
    return x + out


def _cross_fwd(W, name, x, c, pr):
    v = linear(c, W[f"{name}.fn.fn.to_v.weight"], None, pr)
    tok = _c(W, f"{name}.fn.fn.to_out", v[:, :, None, None], pr)
    return x + tok.expand_as(x)


def _mid_attn_fwd(W, x, heads, pr):
    b, c, h, w = x.shape
    xn = rms_norm(x, W["mid_attn.fn.norm.g"])
    qkv = _c(W, "mid_attn.fn.fn.to_qkv", xn, pr)
    rows = [t.reshape(b, -1, h * w).transpose(1, 2) for t in qkv.chunk(3, 1)]
    out = single_head_attention(*rows, pr, heads=heads)
    out = out.transpose(1, 2).reshape(b, -1, h, w)
    return x + _c(W, "mid_attn.fn.fn.to_out", out, pr)


def unet_forward(W, cfg: dict, x, t, classes, pr: Precision):
    """NCHW x [B, C, H, W], t [B], classes [B] -> the prediction, NCHW.
    No class is dropped (cond_drop_prob 0, cond_scale 1)."""
    dim = cfg["dim"]
    c = _mlp(W, "classes_mlp", W["classes_emb.weight"][classes], pr, 0, 2)
    tc = torch.cat([_mlp(W, "time_mlp", _time_embedding(t, dim), pr, 1, 3),
                    c], dim=-1)
    x = _c(W, "init_conv", x, pr, padding=3)
    r, hs = x, []
    levels = _levels(cfg)
    for i in range(len(levels)):
        p = f"downs.{i}"
        x = _resnet_fwd(W, f"{p}.0", x, tc, pr)
        hs.append(x)
        x = _resnet_fwd(W, f"{p}.1", x, tc, pr)
        x = _cross_fwd(W, f"{p}.3", _linear_attn_fwd(W, f"{p}.2", x, pr),
                       c, pr)
        hs.append(x)
        last = i == len(levels) - 1
        x = _c(W, f"{p}.4", x, pr, stride=1 if last else 2, padding=1)
    x = _resnet_fwd(W, "mid_block1", x, tc, pr)
    x = _mid_attn_fwd(W, x, cfg["attn_heads"], pr)
    x = _cross_fwd(W, "mid_cross_attn", x, c, pr)
    x = _resnet_fwd(W, "mid_block2", x, tc, pr)
    for i in range(len(levels)):
        p = f"ups.{i}"
        x = _resnet_fwd(W, f"{p}.0", torch.cat([x, hs.pop()], 1), tc, pr)
        x = _resnet_fwd(W, f"{p}.1", torch.cat([x, hs.pop()], 1), tc, pr)
        x = _cross_fwd(W, f"{p}.3", _linear_attn_fwd(W, f"{p}.2", x, pr),
                       c, pr)
        if i == len(levels) - 1:
            x = _c(W, f"{p}.4", x, pr, padding=1)
        else:
            x = _c(W, f"{p}.4.1", F.interpolate(x, scale_factor=2,
                                                mode="nearest"), pr,
                   padding=1)
    x = _resnet_fwd(W, "final_res_block", torch.cat([x, r], 1), tc, pr)
    return _c(W, "final_conv", x, pr)


# --- the diffusion process -------------------------------------------------

class Schedule:
    """The cosine schedule (s = 0.008, betas clipped at 0.999), built in
    float64 and kept as float32 tensors; pred_v's min-SNR loss weight
    min(snr, gamma) / (snr + 1)."""

    def __init__(self, timesteps: int, gamma: float, device):
        x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
        ac = np.cos(((x / timesteps) + 0.008) / 1.008 * math.pi * 0.5) ** 2
        ac = ac / ac[0]
        betas = np.clip(1 - ac[1:] / ac[:-1], 0, 0.999)
        ac = np.cumprod(1.0 - betas)
        snr = ac / (1.0 - ac)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.timesteps = timesteps
        self.ac = f32(ac)
        self.sqrt_ac = f32(np.sqrt(ac))
        self.sqrt_1mac = f32(np.sqrt(1.0 - ac))
        self.sqrt_recip = f32(np.sqrt(1.0 / ac))
        self.sqrt_recipm1 = f32(np.sqrt(1.0 / ac - 1))
        self.loss_weight = f32(np.minimum(snr, gamma) / (snr + 1))


def _at(table, t):
    return table[t][:, None, None, None]


def draw_step_noise(generator, timesteps: int, batch: int, shape_chw,
                    device):
    """One training step's draws, in the trainer's order from its
    generator: t uniform in [0, T), then the NCHW noise."""
    t = torch.randint(0, timesteps, (batch,), generator=generator,
                      device=device)
    noise = torch.randn((batch, *shape_chw), generator=generator,
                        device=device)
    return t, noise


class LDMReference:
    """Weights, EMA copy and AdamW state of the reference U-Net and its
    training step. `weights` {name: float32 tensor} are copied; the EMA
    starts equal to them."""

    def __init__(self, cfg: dict, weights: dict, pr: Precision, device):
        self.cfg, self.pr = cfg, pr
        self.W = {k: v.detach().clone().requires_grad_(True)
                  for k, v in weights.items()}
        self.ema = {k: v.detach().clone() for k, v in weights.items()}
        self.sched = Schedule(cfg["timesteps"], cfg["min_snr_gamma"], device)
        self.opt = {}

    def loss(self, latents, classes, t, noise):
        """pred_v min-SNR loss of NHWC latents at times t with NCHW noise."""
        s = self.sched
        x0 = latents.permute(0, 3, 1, 2).float()
        xt = _at(s.sqrt_ac, t) * x0 + _at(s.sqrt_1mac, t) * noise
        out = unet_forward(self.W, self.cfg, xt, t, classes, self.pr)
        target = _at(s.sqrt_ac, t) * noise - _at(s.sqrt_1mac, t) * x0
        per = ((out - target) ** 2).mean(dim=(1, 2, 3))
        return (per * s.loss_weight[t]).mean()

    def step(self, latents, classes, t, noise, step: int) -> dict:
        """One step (`step` = steps taken before it): the loss, clipped
        AdamW and the EMA update. Returns {"loss", "grads"} (the clipped
        gradients by name; zero for weights that take no part)."""
        cfg = self.cfg
        loss = self.loss(latents, classes, t, noise)
        names = list(self.W)
        grads = torch.autograd.grad(loss, [self.W[k] for k in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(self.W[k]) if g is None else g
                 for k, g in zip(names, grads)]
        fed = adam_update([self.W[k] for k in names], grads, self.opt,
                          lr=cfg["train_lr"], betas=tuple(cfg["adam_betas"]),
                          eps=1e-8, weight_decay=cfg["weight_decay"],
                          max_norm=cfg["max_grad_norm"])
        self._ema(step)
        return {"loss": float(loss.detach()), "grads": dict(zip(names, fed))}

    def _ema(self, step: int, after: int = 100) -> None:
        """ema_pytorch: every `ema_update_every` steps; a copy up to step
        `after`, then decay min(1 - (1 + epoch)^(-2/3), beta), epoch = step
        - after - 1."""
        cfg = self.cfg
        if step % cfg["ema_update_every"]:
            return
        with torch.no_grad():
            if step <= after:
                for k, v in self.ema.items():
                    v.copy_(self.W[k])
                return
            epoch = step - after - 1
            d = 0.0 if epoch <= 0 else min(max(
                1.0 - (1.0 + epoch) ** (-2.0 / 3.0), 0.0), cfg["ema_decay"])
            for k, v in self.ema.items():
                v.mul_(d).add_(self.W[k] * (1.0 - d))

    def params(self) -> dict:
        out = {f"model.{k}": v.detach() for k, v in self.W.items()}
        out.update({f"ema.{k}": v for k, v in self.ema.items()})
        return out


# --- sampling ----------------------------------------------------------------

def ddim_pairs(timesteps: int, steps: int):
    times = np.linspace(-1, timesteps - 1, num=steps + 1).astype(int)[::-1]
    return [(int(a), int(b)) for a, b in zip(times[:-1], times[1:])]


@torch.no_grad()
def ddim_request(W, cfg: dict, sched: Schedule, classes, generator,
                 pr: Precision, eta: float = 1.0):
    """The DDIM chain of one request: initial NCHW noise, then per step a
    noise draw (the last step's too), pred_v -> x0 clipped to [-1, 1] ->
    eps; x_{t'} = x0 sqrt(a') + sqrt(1 - a' - s^2) eps + s z with s = eta
    sqrt((1 - a / a')(1 - a') / (1 - a)); the last step returns x0.
    Returns NHWC latents."""
    b, c, size = len(classes), cfg["latent_channels"], cfg["latent_size"]
    dev = classes.device
    img = torch.randn((b, c, size, size), generator=generator, device=dev)
    for time, time_next in ddim_pairs(cfg["timesteps"],
                                      cfg["sampling_timesteps"]):
        t = torch.full((b,), time, dtype=torch.long, device=dev)
        z = torch.randn(img.shape, generator=generator, device=dev)
        v = unet_forward(W, cfg, img, t, classes, pr)
        x0 = (_at(sched.sqrt_ac, t) * img - _at(sched.sqrt_1mac, t) * v
              ).clamp(-1.0, 1.0)
        eps = ((_at(sched.sqrt_recip, t) * img - x0)
               / _at(sched.sqrt_recipm1, t))
        if time_next < 0:
            img = x0
            continue
        a = sched.ac[time]
        a_next = sched.ac[time_next]
        sigma = eta * torch.sqrt((1 - a / a_next) * (1 - a_next) / (1 - a))
        cc = torch.sqrt(torch.clamp(1.0 - a_next - sigma ** 2, min=0.0))
        img = x0 * torch.sqrt(a_next) + cc * eps + sigma * z
    return img.permute(0, 2, 3, 1)


@torch.no_grad()
def klvae_decode(W, cfg: dict, latents, pr: Precision):
    """Scaled NHWC latents -> NHWC images clamped to [0, 1]."""
    z = latents.permute(0, 3, 1, 2) / cfg["vae"]["scale_factor"]
    z = conv2d(z, W["post_quant_conv.weight"], W["post_quant_conv.bias"], pr)
    x = ae.decode(W, vae_trunk(cfg), z, pr)
    return x.clamp(0.0, 1.0).permute(0, 2, 3, 1)


# --- FLOPs -------------------------------------------------------------------

def unet_step_flops(cfg: dict, batch: int) -> int:
    """FLOPs of one reference training step (forward + backward) at
    `batch` latents, under fake tensors."""
    from ..work import count_flops

    def step():
        ref = LDMReference(cfg, ae.zeros_like_spec(unet_spec(cfg), "cpu"),
                           Precision(), "cpu")
        size, c = cfg["latent_size"], cfg["latent_channels"]
        loss = ref.loss(torch.zeros(batch, size, size, c),
                        torch.zeros(batch, dtype=torch.long),
                        torch.zeros(batch, dtype=torch.long),
                        torch.zeros(batch, c, size, size))
        torch.autograd.grad(loss, list(ref.W.values()), allow_unused=True)

    return count_flops(step)


def request_flops(cfg: dict, batch: int) -> int:
    """FLOPs of one generation request: `sampling_timesteps` U-Net
    forwards at `batch` and the KL-VAE decode of the batch."""
    from ..work import count_flops

    size, c = cfg["latent_size"], cfg["latent_channels"]

    def forward():
        unet_forward(ae.zeros_like_spec(unet_spec(cfg), "cpu"), cfg,
                     torch.zeros(batch, c, size, size),
                     torch.zeros(batch, dtype=torch.long),
                     torch.zeros(batch, dtype=torch.long), Precision())

    def decode():
        klvae_decode(ae.zeros_like_spec(klvae_spec(cfg), "cpu"), cfg,
                     torch.zeros(batch, size, size, c), Precision())

    return (cfg["sampling_timesteps"] * count_flops(forward)
            + count_flops(decode))
