"""PyTorch/CUDA port of vqgan_tpu for NVIDIA Hopper.

The JAX package `vqgan_tpu` is the reference; this package imports nothing of
it and nothing of JAX. Module names mirror the JAX package. Modules are NCHW
inside; the public functions keep the JAX package's layouts (BSHD attention,
NHWC latents and images). Every Pallas kernel on a ported path is a CUDA C++
kernel in `csrc/`, built at first use (see `kernels/`).

First slice: class-conditional latent-diffusion generation
(`python -m vqgan_tpu_torch.generate`).
"""
