"""The benchmark's frozen yardstick: peaks, work formulas, interval
arithmetic and FLOP counting.

Nothing here reads the program. The formulas of the four hand-written
kernels are copies of `vqgan_tpu_torch/utils/flops.py` (`flash_fwd_work`,
`backward_work`, `vq_work`, the convolution tap rule), frozen so that a
change to the program cannot move the yardstick it is measured by.

- `PEAKS`: NVIDIA's data-sheet rates of one H100 (SXM, dense, at the full
  700 W limit): 989 TFLOP/s bf16, 3.35 TB/s HBM, and fp32 at a third of
  TF32's 495 TFLOP/s (3xTF32, the fastest fp32-accurate product).
- `least_seconds`: the roofline's least time of a piece of work.
- `union_seconds`, `idle_gaps`: busy time and the gaps between device
  intervals.
- `count_flops`: FLOPs of a call of the benchmark's own plain reference,
  under fake tensors (shapes only), convolutions counted by in-image taps.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

PEAKS = {
    "H100": {"bytes_per_s": 3.35e12, "bfloat16": 989e12,
             "float32": 495e12 / 3},
}


def peaks_for(device_name: str) -> dict:
    """The peaks of a card by its name; raises for a card not in `PEAKS`
    (a share of an unknown peak is no number)."""
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    raise KeyError(f"no peaks for {device_name!r}")


# --- the four kernels' work (copied from utils/flops.py) -------------------

def flash_fwd_work(b, s_q, s_kv, h, d, itemsize) -> Tuple[int, int]:
    """(bytes, operations) of the flash forward at [b, s_q, h, d] against
    s_kv keys: q, k, v read once, out and the fp32 LSE written once; 2
    operations per multiply-add of S = QK^T and PV."""
    n_q, n_kv = b * s_q * h * d, b * s_kv * h * d
    return ((2 * n_q + 2 * n_kv) * itemsize + 4 * b * h * s_q,
            4 * b * h * s_q * s_kv * d)


def backward_work(b, s_q, s_kv, h, d, itemsize) -> dict:
    """{kernel: (bytes, operations)} of the two backward kernels: each
    input read once and each output written once (LSE and delta fp32), 2
    operations per multiply-add (dQ: S, dP, dS K; dK/dV: S, dP, P^T dO,
    dS^T Q)."""
    n_q, n_kv = b * s_q * h * d, b * s_kv * h * d
    stats = 2 * 4 * b * h * s_q
    return {
        "flash_bwd_dq": ((3 * n_q + 2 * n_kv) * itemsize + stats,
                         6 * b * h * s_q * s_kv * d),
        "flash_bwd_dkv": ((2 * n_q + 4 * n_kv) * itemsize + stats,
                          8 * b * h * s_q * s_kv * d),
    }


def vq_work(n: int, k: int, d: int) -> Tuple[int, int]:
    """(bytes, operations) of one nearest-code search: z, the codebook and
    |e|^2 read once (fp32), indices and usage written once; 2 N K D
    operations for the cross term."""
    return 4 * (n * d + k * d + k + n + k), 2 * n * k * d


ITEMSIZE = {"bfloat16": 2, "float32": 4}


def least_seconds(peaks: dict, n_bytes: float, flops: float,
                  dtype: str) -> float:
    """The least time the card could take: bytes once at the HBM rate or
    the operations at `dtype`'s peak, whichever is longer."""
    return max(n_bytes / peaks["bytes_per_s"], flops / peaks[dtype])


# --- intervals -------------------------------------------------------------

Interval = Tuple[float, float]


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def union_seconds(intervals: Iterable[Tuple[float, float]], lo: float,
                  hi: float) -> float:
    """Length of the union of the intervals, clipped to [lo, hi]."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merge(intervals))


def idle_gaps(intervals: Iterable[Tuple[float, float]], lo: float,
              hi: float) -> List[Tuple[float, float]]:
    """The gaps of [lo, hi] that no interval covers, as (start, end)."""
    gaps, reach = [], lo
    for s, e in merge(intervals):
        if e <= lo or s >= hi:
            continue
        if s > reach:
            gaps.append((reach, min(s, hi)))
        reach = max(reach, e)
    if reach < hi:
        gaps.append((reach, hi))
    return gaps


# --- FLOPs of the plain reference ------------------------------------------

def _axis_pairs(n_in, n_out, k, stride, pad, dil, transposed) -> int:
    positions, limit = (n_in, n_out) if transposed else (n_out, n_in)
    return sum(1 for p in range(positions) for t in range(k)
               if 0 <= p * stride - pad + t * dil < limit)


def conv_taps_flops(x_shape, w_shape, out_shape, stride, padding, dilation,
                    transposed: bool) -> int:
    """2 x batch x the weight's two channel axes x the product over spatial
    axes of the (position, tap) pairs whose other end lies inside the
    image (XLA's rule: padding is not work)."""
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
    forward = conv_taps_flops(x_shape, w_shape, grad_out_shape, stride,
                              padding, dilation, transposed)
    return forward * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def count_flops(fn, *args, **kwargs) -> int:
    """FLOPs of one call `fn(*args, **kwargs)` under fake tensors: matrix
    products and convolutions (by in-image taps) in forward and backward;
    elementwise work counts zero. `fn` must build its tensors inside the
    call (they are then fake) or take them as arguments."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    aten = torch.ops.aten
    mapping = {aten.convolution: _conv_formula,
               aten._convolution: _conv_formula,
               aten.convolution_backward: _conv_backward_formula}
    counter = FlopCounterMode(display=False, custom_mapping=mapping)
    with FakeTensorMode(allow_non_fake_inputs=True), counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()
