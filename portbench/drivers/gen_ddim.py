"""Per-user generation, a closed loop with one client: each request is
`batch` images of one user's class, the classes cycled over the users in
an order drawn from the seed. A request runs as `generate.main` runs a
batch: `generate.generate_samples` (DDIM at the configuration's
sampling_timesteps and cond_scale, each step a replay of the sampler's
captured graph, the noise drawn from a generator the benchmark seeds),
then the fp32 KL-VAE's `decode_latents`; the client waits for the images
before it sends the next request. Writing JPEGs is left out (host-paced).

Traffic parameters: batch, rescaled_phi, check_requests (requests the
reference repeats), trace_requests.

After the window the reference (`reference/ldm.py`, float32) repeats a
sample of the window's requests drawn from the seed: the DDIM chain from
the same noise (the generator's state at the request's start), once in
float32 and once with bf16 operands, and the decode of the program's
latents. With the fault `faults.CONTROL` the
sampled requests' answers are the control's: the reference's chain in
float8 and its decode with TF32 products, below the configuration's bf16
and float32.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import compare, faults, tracing
from ..harness import Check, Context, Record, free_device, mark, seed_for
from ..reference.layers import Precision, float32_math, tf32_math
from ..reference.ldm import (
    Schedule,
    ddim_request,
    klvae_decode,
    klvae_spec,
    request_flops,
    unet_spec,
)
from ..weights import load_into, make_weights

__all__ = ["run", "reference_gaps", "control_answers"]


def _weights(ctx: Context, device) -> dict:
    return make_weights({"unet": unet_spec(ctx.config),
                         "vae": klvae_spec(ctx.config)},
                        seed_for(ctx.seed, "weights"), device)


def reference_gaps(ctx: Context, done: list, picks, device) -> dict:
    """{"chain", "latent", "image"} over the picked requests, each the
    worst (value, which request): "latent" the relative RMS gap of the
    program's latents from the float32 chain's on the same noise; "chain"
    that gap over the gap of a chain with bf16 operands (the rounding a
    sound bf16 program makes), so that a request whose chain amplifies
    rounding more reads no worse; "image" the relative RMS gap of the
    program's images from the float32 decode of its latents."""
    cfg = ctx.config
    worst = {"chain": (0.0, ""), "latent": (0.0, ""), "image": (0.0, "")}
    with float32_math():
        w = _weights(ctx, device)
        sched = Schedule(cfg["timesteps"], cfg["min_snr_gamma"], device)
        for i in picks:
            user, state, latents, images = done[i]
            classes = torch.full((latents.shape[0],), user, dtype=torch.long,
                                 device=device)
            chains = {}
            for name in ("float32", "bfloat16"):
                gen = torch.Generator(device=device)
                gen.set_state(state)
                chains[name] = ddim_request(w["unet"], cfg, sched, classes,
                                            gen, Precision(name))
            exact = chains["float32"]
            decoded = klvae_decode(w["vae"], cfg, latents, Precision())
            latent = compare.rel_rms_gap(latents, exact)
            gaps = {"chain": latent / max(compare.rel_rms_gap(
                        chains["bfloat16"], exact), 1e-30),
                    "latent": latent,
                    "image": compare.rel_rms_gap(images.to(device), decoded)}
            for k, g in gaps.items():
                if not g <= worst[k][0]:
                    worst[k] = (g, f"request {i} (user {user})")
    return worst


def control_answers(ctx: Context, done: list, picks, device) -> list:
    """`done` with the picked requests' latents and images replaced by
    the control's: the float8 chain from the request's noise, and its
    decode with TF32 products."""
    cfg, out = ctx.config, list(done)
    with float32_math():
        w = _weights(ctx, device)
        sched = Schedule(cfg["timesteps"], cfg["min_snr_gamma"], device)
        for i in picks:
            user, state, latents, _ = done[i]
            gen = torch.Generator(device=device)
            gen.set_state(state)
            classes = torch.full((latents.shape[0],), user, dtype=torch.long,
                                 device=device)
            low = ddim_request(w["unet"], cfg, sched, classes, gen,
                               Precision("float8"))
            with tf32_math():
                images = klvae_decode(w["vae"], cfg, low, Precision())
            out[i] = (user, state, low, images.cpu())
    return out


def run(ctx: Context, device="cuda", fault=None) -> Record:
    """The cell's run on `device`, with `fault` (`faults.py`) planted in
    the program if given; `faults.CONTROL` puts the control's answers in
    the program's place."""
    with faults.fault(fault):
        return _run(ctx, device, fault == faults.CONTROL)


def _run(ctx: Context, device, control: bool) -> Record:
    from vqgan_tpu_torch.configs.ldm_config import LDMConfig
    from vqgan_tpu_torch.device import resolve_device
    from vqgan_tpu_torch.generate import generate_samples, load_model, load_vae
    mark(ctx, "program imported")
    p, dev = ctx.traffic, resolve_device(device)
    cfg = LDMConfig.from_dict(ctx.config)
    diffusion, model = load_model(cfg, None, dev)
    vae = load_vae(None, cfg.latent_channels, cfg.image_size,
                   ctx.config["vae"]["scale_factor"], device=dev)
    mark(ctx, "sampler and decoder built")
    weights = _weights(ctx, dev)
    load_into(model, weights["unet"])
    load_into(vae, weights["vae"])
    del weights
    mark(ctx, "seeded weights loaded")
    on_card = dev.type == "cuda"
    if on_card:  # as generate.main: the fp32 decode in full fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    gen = torch.Generator(device=dev).manual_seed(seed_for(ctx.seed, "noise"))
    users = np.random.default_rng(seed_for(ctx.seed, "users")).permutation(
        cfg.num_users)
    done, count, split = [], [0], [False]

    def request():
        user = int(users[count[0] % len(users)])
        count[0] += 1
        state = gen.get_state()
        with tracing.span("generate"):
            latents = generate_samples(diffusion, user, p["batch"],
                                       cfg.cond_scale, p["rescaled_phi"],
                                       gen)
            if split[0]:  # the traced sub-window times the two apart
                sync()
        with tracing.span("decode"):
            with torch.inference_mode():  # the client's copy waits
                images = vae.decode_latents(latents).float().cpu()
        return user, state, latents, images

    request()  # set-up: the chain's graph and the decode's plans
    setup_s = time.perf_counter() - ctx.started
    mark(ctx, "set-up")
    t0 = time.perf_counter()
    failed = 0
    while True:
        out = request()
        failed += int(not torch.isfinite(out[3]).all())
        done.append(out)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    host = {"setup_s": setup_s, "window_s": window_s,
            "requests": len(done), "images": len(done) * p["batch"],
            "batch": p["batch"], "steps_per_request":
                cfg.sampling_timesteps}
    trace = None
    if ctx.trace:
        def sub():
            split[0] = True
            for _ in range(p["trace_requests"]):
                request()
            return {"requests": p["trace_requests"]}

        trace = tracing.traced(sub)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    capture = diffusion._graphs.stats()["capture_seconds"]
    del diffusion, model, vae
    if on_card:
        free_device()
    rng = np.random.default_rng(seed_for(ctx.seed, "check"))
    picks = sorted(rng.choice(len(done), size=min(p["check_requests"],
                                                  len(done)), replace=False))
    if control:
        done = control_answers(ctx, done, picks, dev)
    found = reference_gaps(ctx, done, picks, dev)
    limits = ctx.cell["checks"]
    work = {}
    if ctx.trace:
        work["request_flops"] = request_flops(ctx.config, p["batch"])
    return Record(
        host=host, counters={"graph_capture_s": capture},
        attempted=len(done), failed=failed,
        checks={k: Check(found[k][0], limits[k]) for k in limits},
        memory_peak_bytes=peak, chips=1,
        device_kind=torch.cuda.get_device_name() if on_card else "cpu",
        trace=trace, work=work,
        notes=found)
