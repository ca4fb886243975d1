"""Export the generation pipeline, or the VQ codec, as a serving artifact.

    python -m vqgan_tpu_torch.export_serving --checkpoint results/ldm \\
        --vae_path kl_vae-1.pt --out serving_artifact [--batch_size 16] \\
        [--cond_scale 1.0] [--rescaled_phi 0.7] \\
        [--params_dtype bfloat16] [--selftest]
    python -m vqgan_tpu_torch.export_serving --mode vq_codec \\
        --vqgan_path results/vqgan/vqgan-1.pt --out codec_artifact \\
        [--selftest]

Counterpart of cli/export_serving.py. Mode `cfg_sampler` packages the
generate.py hot path, the CFG DDIM sampler (U-Net checkpoint of the port's
trainer) and the KL-VAE decode, as a `torch.export` directory
(`serving/export.py`: one step program that the loader loops over, and a
decode program); `serve_generate` and `serve_http` run it with no model
code. Mode `vq_codec` packages the VQ-VAE index codec (images -> int
indices -> images) of a `vqgan-*.pt` checkpoint as two programs.

`--selftest` reloads the artifact and holds it against the live pipeline on
the same noise and classes: images within rtol 1e-4, atol 1e-5 on [0, 1]
pixels; the codec's indices exactly equal and its reconstruction within
rtol 1e-4, atol 1e-5, both sides with cuDNN held to deterministic
algorithms (on the card the decoders' transposed convolution is otherwise
not reproducible from run to run at that tolerance). Under
`--params_dtype bfloat16` the live pipeline
runs on the same bf16-rounded weights, and the drift from the fp32 weights
is printed. Runs on the GPU by default (`--device cpu` to export for the
CPU). `--dp` (data-parallel export) waits for the scale-out slice.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses

import numpy as np
import torch
from torch import nn

from .checkpoint.load import load_vqvae
from .core.diffusion_math import unnormalize_to_zero_to_one
from .device import resolve_device, set_full_fp32_precision
from .diffusion.gaussian import DDIMStep
from .generate import load_checkpoint, load_model, load_vae
from .models import KLVAE, VQVAE
from .serving import (
    export_cfg_sampler,
    export_vq_codec,
    load_cfg_sampler,
    load_vq_codec,
    round_weights,
)

__all__ = ["LatentDecode", "CodecEncode", "CodecDecode", "cfg_programs",
           "live_pipeline", "export_cfg_artifact", "export_codec_artifact",
           "main"]

RTOL, ATOL = 1e-4, 1e-5  # cli/export_serving.py's selftest rule


class LatentDecode(nn.Module):
    """The sampler's final latents (NCHW, in the diffusion's normalised
    range) -> NHWC images in [0, 1]: what `ddim_sample` + `decode_latents`
    do after the last step. It holds the KL-VAE's decoder half alone: an
    exported program keeps every parameter of its module."""

    decode = KLVAE.decode

    def __init__(self, vae: KLVAE, auto_normalize: bool):
        super().__init__()
        self.post_quant_conv, self.decoder = vae.post_quant_conv, vae.decoder
        self.scale_factor, self.dtype = vae.scale_factor, vae.dtype
        self.auto_normalize = auto_normalize

    def forward(self, img):
        z = img.permute(0, 2, 3, 1)
        if self.auto_normalize:
            z = unnormalize_to_zero_to_one(z)
        return KLVAE.decode_latents(self, z)


class CodecEncode(nn.Module):
    """NHWC images -> int32 indices [B, h, w], with the VQ-VAE's encoder
    half alone."""

    encode = VQVAE.encode

    def __init__(self, vqvae: VQVAE):
        super().__init__()
        self.encoder, self.pre_quant_conv = vqvae.encoder, vqvae.pre_quant_conv
        self.quantizer = vqvae.quantizer
        self.post_quant_conv = vqvae.post_quant_conv

    def forward(self, images):
        return VQVAE.encode_to_indices(self, images.permute(0, 3, 1, 2))


class CodecDecode(nn.Module):
    """int32 indices [B, h, w] -> NHWC images, with the VQ-VAE's decoder
    half alone."""

    decode = VQVAE.decode

    def __init__(self, vqvae: VQVAE):
        super().__init__()
        self.quantizer, self.post_quant_conv = (vqvae.quantizer,
                                                vqvae.post_quant_conv)
        self.decoder = vqvae.decoder

    def forward(self, indices):
        return VQVAE.decode_from_indices(self, indices).permute(0, 2, 3, 1)


def cfg_programs(diffusion, vae, cond_scale: float, rescaled_phi: float):
    """(step, decode) modules of the generation pipeline."""
    return (DDIMStep(diffusion, cond_scale, rescaled_phi),
            LatentDecode(vae, diffusion.auto_normalize))


def live_pipeline(diffusion, vae, classes, init_noise, step_noise,
                  cond_scale: float, rescaled_phi: float):
    """The generate.py path on given noise: `ddim_sample`, then the
    KL-VAE's `decode_latents`. NHWC images in [0, 1]."""
    b, c, h, w = init_noise.shape[0], diffusion.channels, \
        diffusion.image_size, diffusion.image_size
    z = diffusion.ddim_sample((b, h, w, c), classes, cond_scale=cond_scale,
                              rescaled_phi=rescaled_phi,
                              init_noise=init_noise, step_noise=step_noise)
    with torch.inference_mode():
        return vae.decode_latents(z)


@contextlib.contextmanager
def _deterministic():
    """cuDNN restricted to deterministic algorithms while the selftest runs
    (restored after). Its default transposed convolution, the KL-VAE and
    VQ-VAE decoders' upsampling, sums in a varying order on the card: two
    live decodes of one batch part by ~2e-05 on [0, 1] pixels, which is
    the tolerance itself. With it pinned the artifact and the live
    pipeline compute bit for bit what they both compute."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def _close(name, got, want, exact=False) -> float:
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=name)
    return float(np.abs(got - want).max())


def export_cfg_artifact(args, device) -> dict:
    """--mode cfg_sampler: returns {"meta", and with --selftest
    "selftest": {"max_abs_diff", "bf16_drift" or None}}."""
    config, weights = load_checkpoint(args.checkpoint, args.milestone)
    diffusion, _ = load_model(config, weights, device)
    vae = load_vae(args.vae_path, config.latent_channels, config.image_size,
                   device=device)
    cond_scale = (config.cond_scale if args.cond_scale is None
                  else args.cond_scale)
    b = args.batch_size
    step, decode = cfg_programs(diffusion, vae, cond_scale,
                                args.rescaled_phi)
    meta = export_cfg_sampler(
        step, decode, args.out, batch_size=b,
        latent_shape=(diffusion.channels, diffusion.image_size,
                      diffusion.image_size),
        ddim_pairs=diffusion.ddim_time_pairs(), num_users=config.num_users,
        cond_scale=cond_scale, rescaled_phi=args.rescaled_phi,
        params_dtype=args.params_dtype,
        config={**dataclasses.asdict(config), "batch_size": b,
                "image_size": config.image_size})
    print(f"exported serving artifact to {args.out} (batch {b}, cond_scale "
          f"{cond_scale}, {args.params_dtype} weights; "
          + ", ".join(f"{k}.pt2 {v['bytes']} bytes in {v['seconds']:.3f} s"
                      for k, v in meta["programs"].items()) + ")")
    out = {"meta": meta}
    if not args.selftest:
        return out

    sampler = load_cfg_sampler(args.out, device)
    gen = torch.Generator(device=device).manual_seed(0)
    h = diffusion.image_size
    init = torch.randn((b, h, h, diffusion.channels), generator=gen,
                       device=device)
    steps = torch.randn((diffusion.sampling_timesteps, *init.shape),
                        generator=gen, device=device)
    classes = torch.zeros((b,), dtype=torch.long, device=device)
    live = dataclasses.replace(
        diffusion, model=round_weights(diffusion.model, args.params_dtype))
    drift = None
    with _deterministic():
        got = sampler(classes, init_noise=init, step_noise=steps)
        want = live_pipeline(live, round_weights(vae, args.params_dtype),
                             classes, init, steps, cond_scale,
                             args.rescaled_phi)
        if args.params_dtype == "bfloat16":
            fp32 = live_pipeline(diffusion, vae, classes, init, steps,
                                 cond_scale, args.rescaled_phi)
            drift = (got - fp32).abs().max().item()
    if drift is not None:
        print(f"bf16-weights pixel drift vs fp32 weights: max|d| "
              f"{drift:.4f} on [0,1]")
    err = _close("artifact vs live pipeline", got, want)
    print(f"selftest OK: artifact == live pipeline (max|d| {err:.2e}), "
          f"output {tuple(got.shape)} in [{got.min().item():.3f}, "
          f"{got.max().item():.3f}]")
    out["selftest"] = {"max_abs_diff": err, "bf16_drift": drift}
    return out


def export_codec_artifact(args, device) -> dict:
    """--mode vq_codec: returns {"meta", and with --selftest "selftest":
    {"recon_max_abs_diff", "codes_used"}}."""
    vqvae, cfg = load_vqvae(args.vqgan_path, args.image_size, device)
    size = cfg.image_size
    latent = size // 2 ** (len(cfg.ch_mult) - 1)
    b = args.batch_size
    encode, decode = CodecEncode(vqvae), CodecDecode(vqvae)
    meta = export_vq_codec(
        encode, decode, args.out, batch_size=b, image_size=size,
        latent_size=latent, params_dtype=args.params_dtype,
        config={"batch_size": b, "image_size": size, "latent_size": latent,
                "num_embeddings": cfg.num_embeddings})
    print(f"exported VQ codec artifact to {args.out} (batch {b}, {size}px "
          f"-> {latent}x{latent} indices of {cfg.num_embeddings}; "
          + ", ".join(f"{k}.pt2 {v['bytes']} bytes in {v['seconds']:.3f} s"
                      for k, v in meta["programs"].items()) + ")")
    out = {"meta": meta}
    if not args.selftest:
        return out

    enc, dec = load_vq_codec(args.out, device)
    gen = torch.Generator(device=device).manual_seed(0)
    images = torch.rand((b, size, size, 3), generator=gen, device=device)
    live = round_weights(vqvae, args.params_dtype)
    with _deterministic(), torch.inference_mode():
        idx = enc(images)
        recon = dec(idx)
        want_idx = CodecEncode(live)(images)
        want = CodecDecode(live)(want_idx)
    _close("codec indices", idx, want_idx, exact=True)
    err = _close("codec reconstruction", recon, want)
    used = int(torch.unique(idx).numel())
    print(f"selftest OK: artifact == live codec, indices "
          f"{tuple(idx.shape)} ({used} codes used), recon "
          f"{tuple(want.shape)} (max|d| {err:.2e})")
    out["selftest"] = {"recon_max_abs_diff": err, "codes_used": used}
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=["cfg_sampler", "vq_codec"],
                    default="cfg_sampler")
    ap.add_argument("--checkpoint", default=None,
                    help="results folder of the port's LDM trainer "
                         "(cfg_sampler mode)")
    ap.add_argument("--milestone", type=int, default=None)
    ap.add_argument("--vae_path", default=None,
                    help="KL-VAE state dict (cfg_sampler mode)")
    ap.add_argument("--vqgan_path", default=None,
                    help="vqgan-*.pt of the port's VQ-GAN trainer, or a "
                         "VQ-VAE state dict (vq_codec mode)")
    ap.add_argument("--image_size", type=int, default=None,
                    help="vq_codec: override the checkpoint's image size")
    ap.add_argument("--out", default="./serving_artifact")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--cond_scale", type=float, default=None)
    ap.add_argument("--rescaled_phi", type=float, default=0.7)
    ap.add_argument("--dp", type=int, default=None,
                    help="data-parallel export over N devices (not ported "
                         "yet: raises for N > 1)")
    ap.add_argument("--params_dtype", choices=["float32", "bfloat16"],
                    default="float32",
                    help="bfloat16 halves the artifact's size; the selftest "
                         "reports the resulting pixel drift")
    ap.add_argument("--selftest", action="store_true",
                    help="reload the artifact and check it matches the live "
                         "pipeline on one batch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mode == "vq_codec" and not args.vqgan_path:
        ap.error("--mode vq_codec requires --vqgan_path")
    if args.mode == "cfg_sampler" and not (args.checkpoint and args.vae_path):
        ap.error("--mode cfg_sampler requires --checkpoint and --vae_path")
    return args


def main(argv=None) -> dict:
    """Export (and self-test) an artifact; returns what `export_*_artifact`
    returns."""
    args = parse_args(argv)
    if args.dp is not None and args.dp > 1:
        raise NotImplementedError(
            "--dp: data-parallel serving artifacts are not ported yet; "
            "export for one device")
    device = resolve_device(args.device)
    set_full_fp32_precision()
    if args.mode == "vq_codec":
        return export_codec_artifact(args, device)
    return export_cfg_artifact(args, device)


if __name__ == "__main__":
    main()
