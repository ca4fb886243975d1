"""`flash_fwd_roofline.train` in the latent-diffusion cell, where it moves
`train_latents_per_s`: the same reader."""

from portbench.run import load_reader

read = load_reader("flash_fwd_roofline.train")
