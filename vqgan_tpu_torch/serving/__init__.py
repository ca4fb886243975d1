"""Serving artifacts: programs saved with `torch.export` and run with no
model code (counterpart of vqgan_tpu/serving)."""

from .export import (
    CFGSampler,
    export_cfg_sampler,
    export_program,
    export_vq_codec,
    load_cfg_sampler,
    load_program,
    load_vq_codec,
    round_weights,
)

__all__ = ["CFGSampler", "export_cfg_sampler", "export_program",
           "export_vq_codec", "load_cfg_sampler", "load_program",
           "load_vq_codec", "round_weights"]
