"""FLOP and byte accounting, the card's peaks, and MFU (model-FLOPs
utilization) reporting.

Counterpart of vqgan_tpu/utils/flops.py. The JAX package reads its counts
from XLA's cost analysis of a lowered or compiled program; PyTorch has no
such analysis, so the port counts what a program dispatches:

- `count_flops(fn, *args)` runs `fn` once under
  `torch.utils.flop_counter.FlopCounterMode` (the counterpart of
  `compiled_flops`, `jit_flops` and `lowered_flops`). By default it runs
  under fake tensors (`FakeTensorMode`): shapes only, no device work, the
  counterpart of `lowered_flops`'s "no backend compile". A program that
  updates state in place (a training step: gradients, optimizer moments)
  would leave fake tensors in its real objects, and one that reads a value
  on the host cannot run without data: count such a program with
  `fake=False`, one real eager call, whose updates then happen.
- Convolutions count by in-image taps, as XLA counts them: for each
  spatial axis only the (output position, kernel tap) pairs whose input
  position falls inside the image, padding excluded (transposed
  convolutions: the (input position, tap) pairs that land inside the
  output). A 3x3 SAME convolution at [2, 32, 32, 64] -> 128 reads
  289,538,048, where PyTorch's stock formula counts every tap,
  301,989,888. The input gradient and the weight gradient each count the
  forward's pairs again. So a count is never above what cuDNN computes,
  and no MFU reads over 1 from padding.
- The four hand-written operators (`torch.ops.vqgan_tpu_torch.*`) are one
  leaf each under the counter: their CPU implementations' inner products
  are not counted again. Their formulas (`OPERATOR_FORMULAS`, `vq_work`)
  count the unpadded sizes the algorithm needs: forward 4 B H Sq Skv d,
  dQ 6 B H Sq Skv d, dK/dV 8 B H Sq Skv d, VQ 2 N K D. The JAX package's
  `pl.CostEstimate` counts the forward and VQ kernels at their padded
  sizes (Sq, Skv rounded up to the block, N and K to the tile), and its
  two backward kernels carry no estimate, so XLA counts them as zero.
- Elementwise operations count zero here; XLA counts one FLOP an element,
  so a whole model's count sits slightly below JAX's (about 0.4% for the
  CFG U-Net).
- A captured loop (a CUDA graph replayed per step) dispatches nothing a
  counter can see: count its eager body and multiply by the trips. In the
  port that product is exact, where JAX's `scan_corrected_flops` corrects
  XLA's count of a scan body once.

`count_bytes` gives the least traffic of a program (the roofline's memory
side): each tensor that existed before the call and that the call reads
is read once, each such tensor it updates in place is written once, and
each tensor it returns is written once. A view counts the span of its
storage that it covers (first to last element, so a strided view counts
the gaps between its rows), the spans of one storage merged; the target
of an `out=` argument or of an overwrite (`copy_`, `fill_`, `zero_`, the
in-place random fills) is written and not read. An operation that updates
part of a tensor in place (`index_put_`, `scatter_`) counts the whole
tensor read and written. For a training step that is the
parameters, optimizer moments, EMA and batch; for one sampler step, the
weights, inputs and outputs. XLA's "bytes accessed" instead sums each
fused operation's operands and outputs; a per-operation sum of eager
traffic would likewise count intermediates that the L2 cache may serve,
and can exceed what the card really moves. The operators' own byte
formulas (`flash_fwd_work`, `backward_work`, `vq_work`) are the same rule
applied to one kernel.

`mfu` and `flops_report` divide by the bf16 dense peak whatever the
program's dtype, as the JAX package does; `roofline` takes the compute
bound at the program's dtype (fp32 at the 3xTF32 rate).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import (
    FlopCounterMode,
    flop_registry,
    register_flop_formula,
)

__all__ = ["PEAKS", "peaks_for", "peak_tflops", "count_flops",
           "count_bytes", "count_work", "conv_taps_flops",
           "flash_fwd_work", "backward_work", "vq_work", "bound",
           "scan_corrected_flops", "mfu", "flops_report", "roofline"]

aten = torch.ops.aten

# NVIDIA data-sheet peaks (SXM parts, dense, at the full 700 W limit). The
# fastest fp32-accurate product on these cards is 3xTF32, three TF32
# products on the tensor cores (495 TFLOP/s), so fp32's rate is a third of
# that, not the 67 TFLOP/s of the fp32 units.
PEAKS = {
    "H100": {"bytes_per_s": 3.35e12, "bfloat16": 989e12,
             "float32": 495e12 / 3},
    "H200": {"bytes_per_s": 4.8e12, "bfloat16": 989e12,
             "float32": 495e12 / 3},
}


def peaks_for(name: str) -> Optional[dict]:
    """The peaks of a card by its name (`torch.cuda.get_device_name`), or
    None for a card not in `PEAKS`."""
    for key in sorted(PEAKS, key=len, reverse=True):
        if key in name:
            return PEAKS[key]
    return None


def _device_name(device=None) -> Optional[str]:
    """The CUDA device's name, or None for the CPU (or no CUDA device)."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_name(device)


def peak_tflops(device=None) -> Optional[float]:
    """Peak bf16 dense TFLOP/s of the given (default: current CUDA) device,
    or None on the CPU or an unknown card."""
    name = _device_name(device)
    peaks = peaks_for(name) if name else None
    return peaks["bfloat16"] / 1e12 if peaks else None


# --- the hand-written operators' work ------------------------------------

def flash_fwd_work(b, s_q, s_kv, h, d, itemsize) -> tuple:
    """(bytes, operations) of the flash forward at [b, s_q, h, d] against
    s_kv keys: q, k, v read once, out and the fp32 LSE written once; 2
    operations per multiply-add of S = QK^T and PV."""
    n_q, n_kv = b * s_q * h * d, b * s_kv * h * d
    return ((2 * n_q + 2 * n_kv) * itemsize + 4 * b * h * s_q,
            4 * b * h * s_q * s_kv * d)


def backward_work(b, s_q, s_kv, h, d, itemsize) -> dict:
    """{kernel name: (bytes, operations)} of the backward kernels at
    [b, s_q, h, d] with s_kv kv rows: each input read once and each output
    written once (LSE and delta in fp32), 2 operations per multiply-add of
    the products (dQ: S, dP, dS K; dK/dV: S, dP, P^T dO, dS^T Q)."""
    n_q, n_kv = b * s_q * h * d, b * s_kv * h * d
    stats = 2 * 4 * b * h * s_q
    return {
        "flash_bwd_dq": ((3 * n_q + 2 * n_kv) * itemsize + stats,
                         6 * b * h * s_q * s_kv * d),
        "flash_bwd_dkv": ((2 * n_q + 4 * n_kv) * itemsize + stats,
                          8 * b * h * s_q * s_kv * d),
    }


def vq_work(n: int, k: int, d: int) -> tuple:
    """(bytes, operations) of one nearest-code search: z, the codebook and
    |e|^2 read once (fp32, as the wrapper takes them), the indices and the
    usage written once; 2 N K D operations for the cross term."""
    return 4 * (n * d + k * d + k + n + k), 2 * n * k * d


def bound(peaks: dict, n_bytes: int, flops: int, dtype: str) -> tuple:
    """(bound ms, "bytes" or "operations"): the least time the card could
    take to move `n_bytes` once or to do `flops` at `dtype`'s peak rate."""
    t_bytes = n_bytes / peaks["bytes_per_s"] * 1e3
    t_ops = flops / peaks[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _attention_dims(q_shape, k_shape):
    b, s_q, h, d = q_shape
    return b, s_q, k_shape[1], h, d


def _flash_fwd_flops(q, k, v, scale, out_shape=None, **kwargs) -> int:
    b, s_q, s_kv, h, d = _attention_dims(q, k)
    return flash_fwd_work(b, s_q, s_kv, h, d, 0)[1]


def _flash_bwd_flops(name):
    def formula(q, k, v, do, lse, delta, scale, out_shape=None, **kwargs):
        b, s_q, s_kv, h, d = _attention_dims(q, k)
        return backward_work(b, s_q, s_kv, h, d, 0)[name][1]
    return formula


def _vq_flops(z, codebook, mode, out_shape=None, **kwargs) -> int:
    return vq_work(z[0], codebook[0], z[1])[1]


# {operator name in torch.ops.vqgan_tpu_torch: its FLOP formula on shapes}
OPERATOR_FORMULAS = {
    "flash_fwd": _flash_fwd_flops,
    "flash_bwd_dq": _flash_bwd_flops("flash_bwd_dq"),
    "flash_bwd_dkv": _flash_bwd_flops("flash_bwd_dkv"),
    "vq_nearest": _vq_flops,
}


def _register_operator_formulas():
    from ..kernels.ops import NAMESPACE  # registers the operators

    ns = getattr(torch.ops, NAMESPACE)
    for name, formula in OPERATOR_FORMULAS.items():
        packet = getattr(ns, name)
        if packet not in flop_registry:
            register_flop_formula(packet)(formula)


_register_operator_formulas()


# --- convolutions by in-image taps ----------------------------------------

def _axis_pairs(n_in, n_out, k, stride, pad, dil, transposed) -> int:
    """Pairs (position, tap) along one axis whose other end lies inside:
    for a convolution, output o and tap t with input o * stride - pad +
    t * dil in [0, n_in); transposed, input i and tap t with output
    i * stride - pad + t * dil in [0, n_out)."""
    positions, limit = (n_in, n_out) if transposed else (n_out, n_in)
    return sum(1 for p in range(positions) for t in range(k)
               if 0 <= p * stride - pad + t * dil < limit)


def conv_taps_flops(x_shape, w_shape, out_shape, stride, padding,
                    dilation, transposed: bool) -> int:
    """FLOPs of one convolution counted by in-image taps (XLA's rule):
    2 x batch x in-channels per group x out-channels x the product over
    spatial axes of the (position, tap) pairs whose other end lies inside
    the image. The channel product is the weight's first two axes either
    way ([Cout, Cin/g] or, transposed, [Cin, Cout/g])."""
    n_axes = len(x_shape) - 2

    def per_axis(v):
        return list(v) * n_axes if len(v) == 1 else list(v)

    stride, padding, dilation = map(per_axis, (stride, padding, dilation))
    pairs = 1
    for a in range(n_axes):
        pairs *= _axis_pairs(x_shape[2 + a], out_shape[2 + a],
                             w_shape[2 + a], stride[a], padding[a],
                             dilation[a], transposed)
    return 2 * x_shape[0] * w_shape[0] * w_shape[1] * pairs


def _conv_formula(x_shape, w_shape, _bias, stride, padding, dilation,
                  transposed, *args, out_shape=None, **kwargs) -> int:
    return conv_taps_flops(x_shape, w_shape, out_shape, stride, padding,
                           dilation, transposed)


def _conv_backward_formula(grad_out_shape, x_shape, w_shape, _bias, stride,
                           padding, dilation, transposed, _output_padding,
                           _groups, output_mask, out_shape=None,
                           **kwargs) -> int:
    """The input gradient and the weight gradient each visit the forward's
    in-image (position, tap) pairs once more."""
    forward = conv_taps_flops(x_shape, w_shape, grad_out_shape, stride,
                              padding, dilation, transposed)
    return forward * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


_CONV_MAPPING = {
    aten.convolution: _conv_formula,
    aten._convolution: _conv_formula,
    aten.convolution_backward: _conv_backward_formula,
}


# --- counting ---------------------------------------------------------------

def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _extent(t: torch.Tensor) -> tuple:
    """(first, last + 1) byte of `t`'s storage that the view `t` covers."""
    if t.numel() == 0:
        return 0, 0
    span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    first = t.storage_offset() * t.element_size()
    return first, first + span * t.element_size()


def _union_bytes(extents) -> int:
    """Bytes covered by a set of (first, end) byte ranges."""
    total, reach = 0, 0
    for first, end in sorted(extents):
        first = max(first, reach)
        if end > first:
            total += end - first
            reach = end
    return total


# operations that overwrite their first argument without reading it
_OVERWRITES = {aten.copy_, aten.fill_, aten.zero_, aten.normal_,
               aten.uniform_, aten.bernoulli_, aten.random_}


class _ByteCounter(TorchDispatchMode):
    """Byte ranges of the tensors that existed before a program and that it
    reads or updates, and the storages it makes; `count_work` adds what it
    returns. A view op moves nothing; the ops that read a view count the
    span it covers, merged per storage."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.made = set()   # storages the program's operations made
        self.read = {}      # storage: {(first, end)} existing and read
        self.written = {}   # storage: {(first, end)} existing and updated
        # held to the end, so that no storage's address is freed for another
        # to take: the tensors from before the program, and under fake
        # tensors every fake seen (each real tensor then keeps one fake, one
        # storage; fakes hold no data)
        self.fake_mode, self.held = fake_mode, []

    def _key(self, t: torch.Tensor) -> int:
        if self.fake_mode is not None:
            if not isinstance(t, FakeTensor):
                t = self.fake_mode.from_tensor(t)
            self.held.append(t)
        return _storage_key(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if func.is_view:
            # a view moves nothing; an op that may alias (`to`, `reshape`
            # under inference mode) and made a copy counts as any other
            inputs = {self._key(t) for t in tree_flatten((args, kwargs))[0]
                      if isinstance(t, torch.Tensor)}
            if all(self._key(t) in inputs for t in outs):
                return out
        written_names = {a.name for a in func._schema.arguments
                         if a.alias_info is not None
                         and a.alias_info.is_write}
        if not outs and not written_names:
            return out  # a query of metadata: nothing is read
        # written and not read: an `out=` argument, or an overwrite's target
        only_written = {a.name for a in func._schema.arguments
                        if a.name in written_names and a.kwarg_only}
        if func.overloadpacket in _OVERWRITES:
            only_written.add(func._schema.arguments[0].name)
        named = dict(zip((a.name for a in func._schema.arguments), args))
        named.update(kwargs)
        for name, value in named.items():
            for t in tree_flatten(value)[0]:
                if not isinstance(t, torch.Tensor):
                    continue
                key = self._key(t)
                if key in self.made:
                    continue
                self.held.append(t)
                if name not in only_written:
                    self.read.setdefault(key, set()).add(_extent(t))
                if name in written_names:
                    self.written.setdefault(key, set()).add(_extent(t))
        for t in outs:
            key = self._key(t)
            if key not in self.read and key not in self.written:
                self.made.add(key)
        return out


def count_work(fn, *args, fake: bool = True, **kwargs) -> tuple:
    """(FLOPs, bytes) of one call `fn(*args, **kwargs)`, by the rules of
    the module docstring. `fake`: run under fake tensors (shapes only, no
    device work, nothing updated); False runs one real eager call."""
    counter = FlopCounterMode(display=False, custom_mapping=_CONV_MAPPING)
    if fake:
        fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
        tracker = _ByteCounter(fake_mode)
        with fake_mode, counter, tracker:
            out = fn(*args, **kwargs)
    else:
        tracker = _ByteCounter()
        with counter, tracker:
            out = fn(*args, **kwargs)
    returned = {}
    for t in tree_flatten(out)[0]:
        if isinstance(t, torch.Tensor) and _storage_key(t) in tracker.made:
            returned.setdefault(_storage_key(t), set()).add(_extent(t))
    n_bytes = sum(_union_bytes(extents)
                  for table in (tracker.read, tracker.written, returned)
                  for extents in table.values())
    return counter.get_total_flops(), n_bytes


def count_flops(fn, *args, fake: bool = True, **kwargs) -> int:
    """FLOPs of one call `fn(*args, **kwargs)` (see `count_work`)."""
    return count_work(fn, *args, fake=fake, **kwargs)[0]


def count_bytes(fn, *args, fake: bool = True, **kwargs) -> int:
    """Least bytes one call `fn(*args, **kwargs)` moves (see
    `count_work`)."""
    return count_work(fn, *args, fake=fake, **kwargs)[1]


# --- reports ----------------------------------------------------------------

def scan_corrected_flops(program_flops: Optional[float],
                         body_flops: Optional[float],
                         n_iters: int) -> Optional[float]:
    """The JAX package's correction for a loop whose body a cost analysis
    counted once: program + (n_iters - 1) x body. In the port a captured
    loop's count is its eager body's times the trips, which is this with
    `program_flops` = `body_flops`."""
    if program_flops is None or body_flops is None:
        return None
    return program_flops + (n_iters - 1) * body_flops


def mfu(flops_per_step: Optional[float], step_time_s: float,
        device=None) -> Optional[float]:
    """Fraction of the card's bf16 peak achieved: (flops/step / time) /
    peak."""
    peak = peak_tflops(device)
    if flops_per_step is None or peak is None or step_time_s <= 0:
        return None
    return (flops_per_step / step_time_s) / (peak * 1e12)


def flops_report(flops_per_step: Optional[float],
                 step_time_s: float, device=None) -> dict:
    """The three driver-facing numbers: FLOPs/step, achieved TFLOP/s, MFU."""
    out = {"flops_per_step": flops_per_step}
    if flops_per_step is not None and step_time_s > 0:
        out["tflops_per_sec"] = round(flops_per_step / step_time_s / 1e12, 2)
    u = mfu(flops_per_step, step_time_s, device)
    out["mfu"] = round(u, 4) if u is not None else None
    return out


def roofline(name: str, flops: float, bytes_: float, dt: float,
             n_items: int, dtype: str = "bfloat16", device=None) -> dict:
    """One program's roofline record, with the JAX package's keys but for
    the two that name TPU hardware: the compute bound is `t_tensor_core_ms`
    (FLOPs over the card's peak at `dtype`, named in `peak_dtype`) and
    `bound` reads "tensor_core" or "hbm". `mfu` is against the bf16 peak.
    On a card not in `PEAKS` (or the CPU) the bounds, MFU and shares are
    None: a CPU run gives no device metric."""
    name_of_card = _device_name(device)
    peaks = peaks_for(name_of_card) if name_of_card else None
    t_tc = flops / peaks[dtype] if peaks and flops else None
    t_hbm = bytes_ / peaks["bytes_per_s"] if peaks and bytes_ else None
    rec = {
        "program": name,
        "t_measured_ms": round(dt * 1e3, 3),
        "items_per_sec": round(n_items / dt, 2),
        "flops": flops, "bytes": bytes_,
        "peak_dtype": dtype,
        "t_tensor_core_ms": round(t_tc * 1e3, 5) if t_tc else None,
        "t_hbm_ms": round(t_hbm * 1e3, 5) if t_hbm else None,
        "mfu": (round(flops / dt / peaks["bfloat16"], 6)
                if peaks and flops else None),
        "hbm_util": (round(bytes_ / dt / peaks["bytes_per_s"], 6)
                     if t_hbm else None),
    }
    if t_tc and t_hbm:
        rec["bound"] = "tensor_core" if t_tc >= t_hbm else "hbm"
        rec["roofline_fraction"] = round(max(t_tc, t_hbm) / dt, 6)
    if flops and bytes_:
        rec["arith_intensity_flops_per_byte"] = round(flops / bytes_, 2)
    return rec
