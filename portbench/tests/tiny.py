"""Tiny versions of the cells for CPU tests: the same drivers, files,
arithmetic and limits at small widths and sizes, the program on the CPU
(its kernels' plain versions, steps run eagerly)."""

from __future__ import annotations

import json
import time

from portbench.harness import ROOT, Context

VQGAN = dict(image_size=32, ch=8, ch_mult=[1, 2], num_res_blocks=1,
             attn_resolutions=[], z_channels=8, num_embeddings=8,
             embedding_dim=8, disc_ndf=8, disc_n_layers=2, batch_size=4,
             learning_rate=1e-3, disc_learning_rate=1e-3,
             compute_dtype="float32")
LDM = dict(dim=8, dim_mults=[1, 2], attn_heads=2, attn_dim_head=8,
           latent_size=8, image_size=64, train_batch_size=4,
           sampling_timesteps=4, train_lr=1e-3, compute_dtype="float32",
           vae=dict(ch=128, ch_mult=[1, 2, 2, 4], num_res_blocks=2,
                    attn_resolutions=[16], z_channels=4,
                    scale_factor=0.18215, compute_dtype="float32"))
TRAFFIC = {"vqgan256_train_gd": dict(pool=8, trace_blocks=1, scan_block=2),
           "ldm_train_scan": dict(pool=8, trace_blocks=1, scan_block=2),
           "ldm_gen_ddim150": dict(batch=2, check_requests=2,
                                   trace_requests=1)}


CELLS = sorted(TRAFFIC)


def tiny_cell(workload: str, seed: int = 7, seconds: float = 0.2,
              trace: bool = False) -> Context:
    """The cell at small sizes, held to its own limits."""
    cell = json.loads((ROOT / "workloads" / f"{workload}.json").read_text())
    config = json.loads((ROOT / "configs" / f"{cell['config']}.json"
                         ).read_text())
    config.update(VQGAN if config["image_size"] == 256 and "ch" in config
                  else LDM)
    cell["traffic_params"] = {**cell["traffic_params"],
                              **TRAFFIC.get(workload, {})}
    return Context(workload=workload, seed=seed, seconds=seconds,
                   trace=trace, cell=cell, config=config,
                   started=time.perf_counter())
