"""Tensor-parallel placement rules over the mesh's "model" axis.

Counterpart of vqgan_tpu/parallel/tp.py, with its keys: the kernels of
`to_qkv`, `to_q`, `to_k` and `to_v` are column-parallel (their output
features split over "model") and the kernels of `to_out` row-parallel
(their input features split). A kernel is the weight of a convolution or
a linear layer; torch keeps those as [out, in, *k] and [out, in] where
flax keeps [*k, in, out] and [in, out], so the rule is read in flax's
order and mapped back (`fsdp.jax_layout`).

How the placement is used: the trainer (`fsdp.ShardedState`) stores each
rank's piece of these kernels, with their Adam moments and EMA, and
gathers them over "model" for the step, as GSPMD gathers a kernel whose
placement its consumer does not take. JAX's spec splits the fused qkv
output contiguously (for 2 ranks: q with half of k, then the rest of k
with v), which is not a split by heads, so head-parallel attention would
need another order of the rows than JAX's placement.

`tp_param_specs` gives a module's parameters the same placement as a
table, name -> spec, for the serving artifacts (`serving/export.py`'s
`param_specs`), which hold each rank's pieces and gather them when the
program runs.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from torch import nn

__all__ = ["tp_spec_for_path", "tp_param_specs", "apply_tp_sharding"]

# column-parallel: output features split over 'model'
_COL_KEYS = ("to_qkv", "to_q", "to_k", "to_v")
# row-parallel: input features split over 'model' (the all-reduce point)
_ROW_KEYS = ("to_out",)


def tp_spec_for_path(path: str, leaf, layout: Optional[Sequence[int]] = None,
                     is_kernel: Optional[bool] = None) -> tuple:
    """The TP placement of the parameter named `path` ("a.b.to_qkv.weight").
    `layout` lists the tensor's dimensions in flax's order (default: the
    same order); `is_kernel` says whether it is a convolution's or linear
    layer's weight (default: a "weight" of 2 or more dimensions)."""
    ndim = len(leaf.shape)
    layout = tuple(range(ndim)) if layout is None else tuple(layout)
    if is_kernel is None:
        is_kernel = path.endswith("weight") and ndim >= 2
    if is_kernel and ndim >= 2:
        spec = [None] * ndim
        if any(k in path for k in _COL_KEYS):
            spec[layout[-1]] = "model"
            return tuple(spec)
        if any(k in path for k in _ROW_KEYS):
            spec[layout[-2]] = "model"
            return tuple(spec)
    return ()


def tp_param_specs(module: nn.Module, mesh=None) -> Dict[str, tuple]:
    """The TP placement of each parameter of `module` that it splits, in
    torch's dimension order: name -> spec ("model" on the split dimension,
    None elsewhere); the parameters it does not list stay whole. With
    `mesh`, a split dimension that does not divide by its "model" size
    raises, as JAX's NamedSharding does."""
    from .fsdp import jax_layout

    out = {}
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if name in out:
                continue
            spec = tp_spec_for_path(name, p, *jax_layout(mod, pname, p.ndim))
            if not spec:
                continue
            n = 1 if mesh is None else mesh.shape.get("model", 1)
            dim = spec.index("model")
            if p.shape[dim] % n:
                raise ValueError(
                    f"{name}: dimension {dim} of {tuple(p.shape)} does not "
                    f"divide over {n} 'model' ranks")
            out[name] = spec
    return out


def apply_tp_sharding(model: nn.Module, mesh) -> Dict[str, object]:
    """Each parameter's piece on this rank under the TP placement
    (everything else whole): name -> tensor."""
    from .fsdp import shard_tensor, state_specs

    specs = state_specs(model, mesh, "tp")["params"]
    return {name: shard_tensor(p.detach(), specs[name], mesh)
            for name, p in model.named_parameters()}
