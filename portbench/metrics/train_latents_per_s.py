"""The latent-diffusion cell's training rate: latents completed per second
of the measured window (a rate of its own, apart from the VQ-GAN's
`train_samples_per_s`: its host-bound runs spread ~5x wider, and one
bound for both would hide a VQ-GAN loss)."""


def read(record):
    host = record.host
    if "samples" not in host or not host["window_s"]:
        return None
    return host["samples"] / host["window_s"]
