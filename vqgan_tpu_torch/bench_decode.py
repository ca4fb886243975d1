"""Microbenchmark: the native C++ JPEG batch decoder against the PIL path.

    python -m vqgan_tpu_torch.bench_decode [--n 256] [--src 256] \\
        [--size 128] [--threads 8] [--iters 3]

Counterpart of cli/bench_decode.py: writes `--n` seeded `--src` px JPEGs
once, then times batch assembly (Resize of the shorter side + CenterCrop +
[0, 1] float32) through both paths. A host-side benchmark: it touches no
device. Prints the JAX CLI's two lines, then one JSON line with both rates
(`native_img_per_s` null, and the reason printed, where the decoder library
cannot be built).
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np

__all__ = ["main", "write_jpegs"]


def write_jpegs(folder: Path, n: int, src: int, seed: int = 0) -> list:
    """`n` JPEGs of seeded uniform noise, `src` px square, quality 92."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        arr = rng.integers(0, 255, (src, src, 3), dtype=np.uint8)
        p = folder / f"{i:04d}.jpg"
        Image.fromarray(arr).save(p, quality=92)
        paths.append(p)
    return paths


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--src", type=int, default=256, help="stored JPEG size")
    ap.add_argument("--size", type=int, default=128, help="target size")
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--paths", nargs="*", default=None,
                    help="decode these JPEGs instead of writing --n of them")
    args = ap.parse_args(argv)

    from .data.datasets import load_image
    from .data.native_image import decode_jpeg_batch, load_decoder_lib

    def timeit(fn):
        fn()  # warm the page cache and the library build
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn()
        return (time.perf_counter() - t0) / args.iters

    with tempfile.TemporaryDirectory(prefix="bench_decode_") as tmp:
        paths = ([Path(p) for p in args.paths] if args.paths else
                 write_jpegs(Path(tmp), args.n, args.src))
        n = len(paths)
        dt_pil = timeit(lambda: np.stack(
            [load_image(p, args.size) for p in paths]))
        dt_nat = None
        if load_decoder_lib() is not None:
            dt_nat = timeit(
                lambda: decode_jpeg_batch(paths, args.size, args.threads))

    print(f"PIL per-item:      {n / dt_pil:8.1f} img/s")
    if dt_nat is not None:
        print(f"native (x{args.threads} thr): {n / dt_nat:8.1f} img/s "
              f"({dt_pil / dt_nat:.2f}x)")
    else:
        print("native: unavailable")
    result = {"n": n, "size": args.size, "threads": args.threads,
              "pil_img_per_s": n / dt_pil,
              "native_img_per_s": n / dt_nat if dt_nat else None}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
