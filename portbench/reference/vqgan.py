"""The VQ-GAN's training step in plain float32: VQ-VAE, PatchGAN with
BatchNorm, VGG16-LPIPS, the losses and two clipped Adam updates.

As in the reference repository's `vqgan_ldm_baseline/train_vqgan.py`
(heimaoqqq/vq-gan) and the JAX package that follows it, past
`disc_start` one step is:

- G: x -> encoder -> nearest code of the codebook (squared distance,
  first index on ties; or the program's code, judged by `quantize`) ->
  straight-through estimator -> decoder ->
  sigmoid; loss = mean |x - x'| + w_p mean LPIPS(x', x) + w_d
  (-mean D(x')) + codebook term + beta commitment term, D read in eval
  mode (running statistics) and not updated; then clip + Adam on the
  VQ-VAE;
- D: hinge loss 0.5 (mean relu(1 - D(x)) + mean relu(1 + D(sg x'))) with
  two train-mode BatchNorm passes, real then fake (each moves the running
  statistics); then clip + Adam on D.

LPIPS: VGG16 to relu5_3 on (2x - 1 - shift) / scale, each of the five
taps unit-normalised over channels (f / sqrt(sum f^2 + 1e-10)), squared
differences weighted by |w| and summed over channels, mean over space,
summed over taps. Its weights take no update.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import autoencoder as ae
from .layers import (
    Precision,
    adam_update,
    batch_norm,
    conv2d,
)

__all__ = ["vqgan_spec", "VQGANReference", "vqgan_step_flops"]

_VGG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
        512, 512, 512]
_TAPS = [3, 8, 15, 22, 29]  # relu1_2 ... relu5_3 in torchvision's features
_TAP_CHANNELS = [64, 128, 256, 512, 512]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _trunk_cfg(cfg: dict) -> dict:
    return {**{k: cfg[k] for k in ("ch", "ch_mult", "num_res_blocks",
                                   "attn_resolutions", "z_channels",
                                   "in_channels", "out_channels")},
            "resolution": cfg["image_size"]}


def vqgan_spec(cfg: dict) -> dict:
    """{"vqvae": spec, "disc": spec, "lpips": spec}, each {name: (shape,
    kind)}, with the program's module names."""
    if cfg["z_channels"] != cfg["embedding_dim"]:
        raise ValueError("the reference has no pre/post-quant convolutions")
    vq = ae.trunk_spec(_trunk_cfg(cfg))
    vq["quantizer.embedding.weight"] = ((cfg["num_embeddings"],
                                         cfg["embedding_dim"]), "codebook")
    disc = {}
    ndf, n_layers = cfg["disc_ndf"], cfg["disc_n_layers"]
    disc["main.0.weight"] = ((ndf, cfg["in_channels"], 4, 4), "fan_in")
    disc["main.0.bias"] = ((ndf,), "bias")
    mult = 1
    for n in range(1, n_layers + 1):
        prev, mult = mult, min(2 ** n, 8)
        disc[f"main.{3 * n - 1}.weight"] = ((ndf * mult, ndf * prev, 4, 4),
                                            "fan_in")
        bn = f"main.{3 * n}"
        disc[f"{bn}.weight"] = ((ndf * mult,), "gain")
        disc[f"{bn}.bias"] = ((ndf * mult,), "bias")
        disc[f"{bn}.running_mean"] = ((ndf * mult,), "zeros")
        disc[f"{bn}.running_var"] = ((ndf * mult,), "ones")
    last = 3 * n_layers + 2
    disc[f"main.{last}.weight"] = ((1, ndf * mult, 4, 4), "fan_in")
    disc[f"main.{last}.bias"] = ((1,), "bias")
    lp = {}
    c_in, pos = 3, 0
    for spec in _VGG:
        if spec == "M":
            pos += 1
            continue
        lp[f"vgg.features.{pos}.weight"] = ((spec, c_in, 3, 3), "fan_in")
        lp[f"vgg.features.{pos}.bias"] = ((spec,), "bias")
        c_in, pos = spec, pos + 2
    for i, c in enumerate(_TAP_CHANNELS):
        lp[f"lin{i}.model.1.weight"] = ((1, c, 1, 1), "gain")
    return {"vqvae": vq, "disc": disc, "lpips": lp}


def quantize(z, codebook, beta: float, codes=None):
    """NCHW z -> (z_q with the straight-through estimator, codebook +
    beta commitment loss, the codes [B, h, w] taken, their shift).

    Without `codes`, each position takes its nearest code (distances
    |z|^2 + |e|^2 - 2 z.e, first index on ties) and the shift is 0. With
    `codes` (the program's choice for the first rows, [B', h, w], B' <= B)
    those rows take the program's codes, and the shift judges them: at
    each position, the distance from z to the boundary at which the
    program's code becomes as near as the nearest one, |z - e_p|^2 -
    |z - e_b|^2 over 2 |e_p - e_b|, as a share of |z|; the largest over
    the positions. Rows the program gave no code for take their nearest
    code, and the shift is then infinite: an answer that never came (as
    it is for codes of another shape)."""
    b, c, h, w = z.shape
    flat = z.permute(0, 2, 3, 1).reshape(-1, c)
    shift = 0.0
    with torch.no_grad():
        dist = ((flat * flat).sum(1, keepdim=True)
                + (codebook * codebook).sum(1)[None, :]
                - 2.0 * flat @ codebook.t())
        idx = torch.argmin(dist, dim=1)
        if codes is not None and (tuple(codes.shape[1:]) != (h, w)
                                  or codes.shape[0] > b):
            codes, shift = None, float("inf")  # codes of another shape
        if codes is not None:
            given = codes.to(idx.device, torch.long).reshape(-1)
            n = given.numel()
            best, zn = idx[:n], flat[:n]
            e_p, e_b = codebook[given], codebook[best]
            gap = ((e_p - e_b) * (e_p + e_b - 2.0 * zn)).sum(1)
            apart = (e_p - e_b).norm(dim=1)
            moved = (given != best) & (apart > 0)
            need = torch.where(
                moved, gap.clamp(min=0) / (2.0 * apart.clamp(min=1e-30)
                                           * zn.norm(dim=1).clamp(min=1e-30)),
                torch.zeros_like(gap))
            shift = float(need.max()) if n else 0.0
            if n < idx.numel():
                shift = float("inf")
            idx = torch.cat([given, idx[n:]])
    zq = codebook[idx].reshape(b, h, w, c).permute(0, 3, 1, 2)
    codebook_loss = torch.mean((zq - z.detach()) ** 2)
    commitment = torch.mean((zq.detach() - z) ** 2)
    return (z + (zq - z).detach(), codebook_loss + beta * commitment,
            idx.reshape(b, h, w), shift)


def patchgan(W, x, pr: Precision, n_layers: int, train: bool):
    h = F.leaky_relu(conv2d(x, W["main.0.weight"], W["main.0.bias"], pr,
                            stride=2, padding=1), 0.2)
    for n in range(1, n_layers + 1):
        h = conv2d(h, W[f"main.{3 * n - 1}.weight"], None, pr,
                   stride=2 if n < n_layers else 1, padding=1)
        bn = f"main.{3 * n}"
        h = batch_norm(h, W[f"{bn}.weight"], W[f"{bn}.bias"],
                       W[f"{bn}.running_mean"], W[f"{bn}.running_var"], train)
        h = F.leaky_relu(h, 0.2)
    last = 3 * n_layers + 2
    return conv2d(h, W[f"main.{last}.weight"], W[f"main.{last}.bias"], pr,
                  padding=1)


def lpips(W, x, y, pr: Precision):
    """[B] distances of NCHW images in [-1, 1]."""
    b = x.shape[0]
    shift = torch.tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
    h = (torch.cat([x, y]) - shift) / scale
    feats, pos = [], 0
    for spec in _VGG:
        if spec == "M":
            h = F.max_pool2d(h, 2)
            pos += 1
            continue
        h = F.relu(conv2d(h, W[f"vgg.features.{pos}.weight"],
                          W[f"vgg.features.{pos}.bias"], pr, padding=1))
        if pos + 1 in _TAPS:
            feats.append(h)
        pos += 2
    total = 0.0
    for i, f in enumerate(feats):
        unit = f * torch.rsqrt((f * f).sum(dim=1, keepdim=True) + 1e-10)
        diff = (unit[:b] - unit[b:]) ** 2
        w = W[f"lin{i}.model.1.weight"].abs()
        total = total + (diff * w).sum(dim=1).mean(dim=(1, 2))
    return total


class VQGANReference:
    """The training state of the reference (weights, running statistics,
    Adam moments) and its step. `weights` maps "vqvae", "disc", "lpips" to
    {name: float32 tensor}; they are copied."""

    def __init__(self, cfg: dict, weights: dict, pr: Precision):
        self.cfg = cfg
        self.trunk = _trunk_cfg(cfg)
        self.pr = pr
        self.vq = {k: v.detach().clone().requires_grad_(True)
                   for k, v in weights["vqvae"].items()}
        self.disc = {k: v.detach().clone() for k, v in weights["disc"].items()}
        for k, v in self.disc.items():
            if not k.endswith(("running_mean", "running_var")):
                v.requires_grad_(True)
        self.lp = {k: v.detach() for k, v in weights["lpips"].items()}
        self.opt_g, self.opt_d = {}, {}

    def disc_params(self) -> dict:
        return {k: v for k, v in self.disc.items() if v.requires_grad}

    def _g_loss(self, x, codes=None):
        """(G's total loss, the reconstruction, the codes taken, their
        shift) of NCHW images x; `codes` as `quantize` takes them."""
        cfg, pr = self.cfg, self.pr
        z = ae.encode(self.vq, self.trunk, x, pr)
        zq, vq_loss, idx, shift = quantize(
            z, self.vq["quantizer.embedding.weight"], cfg["commitment_cost"],
            codes)
        recon = torch.sigmoid(ae.decode(self.vq, self.trunk, zq, pr))
        frozen = {k: v.detach() for k, v in self.disc.items()}
        logits_fake = patchgan(frozen, recon, pr, cfg["disc_n_layers"],
                               train=False)
        rec = torch.mean(torch.abs(x - recon))
        p = torch.mean(lpips(self.lp, recon * 2.0 - 1.0, x * 2.0 - 1.0, pr))
        total = (rec + cfg["perceptual_weight"] * p
                 + cfg["disc_weight"] * -torch.mean(logits_fake) + vq_loss)
        return total, recon, idx, shift

    def _d_loss(self, x, recon):
        n = self.cfg["disc_n_layers"]
        real = patchgan(self.disc, x, self.pr, n, train=True)
        fake = patchgan(self.disc, recon.detach(), self.pr, n, train=True)
        return 0.5 * (torch.mean(F.relu(1.0 - real))
                      + torch.mean(F.relu(1.0 + fake)))

    def step(self, images, codes=None) -> dict:
        """One G + D step on NHWC images in [0, 1] (past disc_start), the
        quantizer following `codes` (the program's, see `quantize`) where
        given. Returns {"g_loss", "d_loss", "g_grads", "d_grads", "codes",
        "code_shift"}: the losses, the clipped gradients each optimizer
        was fed, by name, the codes taken and their shift."""
        x = images.permute(0, 3, 1, 2).float()
        total, recon, idx, shift = self._g_loss(x, codes)
        names = list(self.vq)
        grads = torch.autograd.grad(total, [self.vq[k] for k in names])
        g_fed = adam_update([self.vq[k] for k in names], list(grads),
                            self.opt_g, **self._adam())
        dp = self.disc_params()
        d_loss = self._d_loss(x, recon)
        dgrads = torch.autograd.grad(d_loss, list(dp.values()))
        d_fed = adam_update(list(dp.values()), list(dgrads), self.opt_d,
                            **self._adam(disc=True))
        return {"g_loss": float(total.detach()),
                "d_loss": float(d_loss.detach()),
                "g_grads": dict(zip(names, g_fed)),
                "d_grads": dict(zip(dp, d_fed)),
                "codes": idx.cpu(), "code_shift": shift}

    def gradients_only(self, images) -> None:
        """The step's forward passes and gradients, with no update and no
        host read: what `vqgan_step_flops` counts under fake tensors."""
        x = images.permute(0, 3, 1, 2).float()
        total, recon, _, _ = self._g_loss(x)
        torch.autograd.grad(total, list(self.vq.values()))
        torch.autograd.grad(self._d_loss(x, recon),
                            list(self.disc_params().values()))

    def _adam(self, disc: bool = False) -> dict:
        cfg = self.cfg
        return dict(lr=cfg["disc_learning_rate" if disc else "learning_rate"],
                    betas=tuple(cfg["adam_betas"]), eps=1e-8,
                    weight_decay=cfg["weight_decay"],
                    max_norm=cfg["max_grad_norm"])

    def params(self) -> dict:
        """Every trained leaf by name ("vqvae." / "disc." prefixed)."""
        out = {f"vqvae.{k}": v.detach() for k, v in self.vq.items()}
        out.update({f"disc.{k}": v.detach()
                    for k, v in self.disc_params().items()})
        return out


def vqgan_step_flops(cfg: dict, batch: int) -> int:
    """FLOPs of one reference G + D step at `batch` images (forward and
    backward), counted under fake tensors."""
    from ..work import count_flops

    def step():
        spec = vqgan_spec(cfg)
        weights = {part: ae.zeros_like_spec(s, "cpu")
                   for part, s in spec.items()}
        ref = VQGANReference(cfg, weights, Precision())
        size = cfg["image_size"]
        ref.gradients_only(torch.zeros(batch, size, size,
                                       cfg["in_channels"]))

    return count_flops(step)

