"""The four hand-written kernels as PyTorch operators, one namespace:

    torch.ops.vqgan_tpu_torch.flash_fwd(q, k, v, scale) -> (out, lse)
    torch.ops.vqgan_tpu_torch.flash_bwd_dq(q, k, v, dout, lse, delta,
                                           scale) -> dq
    torch.ops.vqgan_tpu_torch.flash_bwd_dkv(q, k, v, dout, lse, delta,
                                            scale) -> (dk, dv)
    torch.ops.vqgan_tpu_torch.vq_nearest(z, codebook, mode) -> (idx, usage)

Each has a schema and three implementations, picked by PyTorch's
dispatcher from the inputs' device:
- CUDA: the ctypes launch of the kernel (`flash_fwd.py`, `flash_bwd.py`,
  `vq.py`) with its checks, its error codes raised and its launch counted.
  It never falls back to the plain version: a failed build or launch
  raises.
- CPU: the kernel's plain version (`reference.py`), its outputs made
  contiguous like the kernel's.
- fake: the shapes and dtypes of the outputs alone. `torch.export` traces
  through it, so an exported program holds the operators as graph nodes,
  and at run time they dispatch to the kernels again. The VQ wrapper's
  padding and alignment checks run only in the CUDA implementation.

They are registered with `torch.library.Library.define` and `impl`, which
costs the host less per call than `torch.library.custom_op`; the U-Net's
small attention calls are bound by that host time. Importing this module
registers the operators and builds nothing. The models reach them through
`ops/attention.py` and `ops/vq.py`; a host that loads an exported program
imports this module first.
"""

from __future__ import annotations

import torch

from . import reference
from .flash_bwd import flash_bwd_dkv, flash_bwd_dq
from .flash_fwd import flash_fwd
from .vq import vq_nearest

__all__ = ["NAMESPACE", "OPS", "flash_fwd_op", "flash_bwd_dq_op",
           "flash_bwd_dkv_op", "vq_nearest_op"]

NAMESPACE = "vqgan_tpu_torch"
_BWD_ARGS = ("Tensor q, Tensor k, Tensor v, Tensor dout, Tensor lse, "
             "Tensor delta, float scale")
_SCHEMAS = {
    "flash_fwd": "flash_fwd(Tensor q, Tensor k, Tensor v, float scale) "
                 "-> (Tensor, Tensor)",
    "flash_bwd_dq": f"flash_bwd_dq({_BWD_ARGS}) -> Tensor",
    "flash_bwd_dkv": f"flash_bwd_dkv({_BWD_ARGS}) -> (Tensor, Tensor)",
    "vq_nearest": "vq_nearest(Tensor z, Tensor codebook, str mode) "
                  "-> (Tensor, Tensor)",
}


def _contiguous(fn):
    """`fn` with its outputs made contiguous, as the kernels write theirs
    and the fake implementations describe them."""
    def call(*args):
        out = fn(*args)
        if isinstance(out, tuple):
            return tuple(t.contiguous() for t in out)
        return out.contiguous()

    return call


def _vq_cuda(z, codebook, mode):
    e32 = codebook.float()
    return vq_nearest(z.float(), e32, (e32 * e32).sum(1), mode)


def _vq_cpu(z, codebook, mode):
    _, idx = reference.vq_lookup_reference(z, codebook, mode)
    return idx, reference.codebook_usage(idx, codebook.shape[0])


def _fwd_fake(q, k, v, scale):
    b, s_q, h, d = q.shape
    return (q.new_empty((b, s_q, h, d)),
            q.new_empty((b, h, s_q), dtype=torch.float32))


def _dq_fake(q, k, v, dout, lse, delta, scale):
    return q.new_empty(q.shape)


def _dkv_fake(q, k, v, dout, lse, delta, scale):
    return k.new_empty(k.shape), k.new_empty(k.shape)


def _vq_fake(z, codebook, mode):
    return (z.new_empty((z.shape[0],), dtype=torch.int32),
            z.new_empty((codebook.shape[0],), dtype=torch.int32))


_IMPLS = {
    "flash_fwd": (flash_fwd, reference.flash_forward_reference, _fwd_fake),
    "flash_bwd_dq": (flash_bwd_dq, reference.flash_bwd_dq_reference,
                     _dq_fake),
    "flash_bwd_dkv": (flash_bwd_dkv, reference.flash_bwd_dkv_reference,
                      _dkv_fake),
    "vq_nearest": (_vq_cuda, _vq_cpu, _vq_fake),
}

_LIB = torch.library.Library(NAMESPACE, "DEF")
for _name, (_cuda, _cpu, _fake) in _IMPLS.items():
    _LIB.define(_SCHEMAS[_name])
    _LIB.impl(_name, _cuda, "CUDA")
    _LIB.impl(_name, _contiguous(_cpu), "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake, lib=_LIB)

_NS = getattr(torch.ops, NAMESPACE)
flash_fwd_op = _NS.flash_fwd.default
flash_bwd_dq_op = _NS.flash_bwd_dq.default
flash_bwd_dkv_op = _NS.flash_bwd_dkv.default
vq_nearest_op = _NS.vq_nearest.default
# every operator, by the name of its kernel in `KERNELS`
OPS = {"flash_fwd": flash_fwd_op, "flash_bwd_dq": flash_bwd_dq_op,
       "flash_bwd_dkv": flash_bwd_dkv_op, "vq_nearest": vq_nearest_op}
