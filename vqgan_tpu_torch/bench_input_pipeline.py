"""Input-pipeline microbenchmark: the Python BatchLoader (PIL) against the
native C++ decoder, synchronous and as the async ring.

    python -m vqgan_tpu_torch.bench_input_pipeline [--n_images 96] \\
        [--image_size 256] [--decode_size 128] [--batch 8] \\
        [--n_batches 30] [--step_ms 20] [--threads 2]

Counterpart of cli/bench_input_pipeline.py: writes a seeded JPEG folder,
then measures steady-state batches/s of (a) the BatchLoader decoding with
PIL per item, (b) the BatchLoader over `ImageFolderDataset.get_batch`
(the native decoder, synchronous on the loader's thread) and (c)
`NativeBatchLoader` (the async C++ ring). A consumer-side sleep of
`--step_ms` stands in for the device step, so the ring's overlap of decode
and compute shows (`--step_ms 0` for the raw decode rate). One JSON line
per loader, each with `vs_baseline` against (a); (b) and (c) are left out,
with the reason printed, where the decoder library cannot be built. A
host-side benchmark: it touches no device.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

__all__ = ["main", "make_dataset", "run"]


def make_dataset(root: Path, n: int, size: int) -> dict:
    """`n` seeded noise JPEGs of `size` px in root/ID_1 and their split."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    (root / "ID_1").mkdir(parents=True, exist_ok=True)
    names = []
    for i in range(n):
        arr = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
        p = root / "ID_1" / f"img{i:03d}.jpg"
        Image.fromarray(arr).save(p, quality=92)
        names.append(p.name)
    return {"users": {"ID_1": {"train_images": names, "test_images": []}}}


def run(loader, n_batches: int, step_ms: float, warmup: int = 3) -> float:
    """Batches/s of `loader` over `n_batches` after `warmup`, sleeping
    `step_ms` after each."""
    it = iter(loader)
    try:
        for _ in range(warmup):
            next(it)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            next(it)
            if step_ms:
                time.sleep(step_ms / 1e3)
        return n_batches / (time.perf_counter() - t0)
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()  # stops a BatchLoader's thread


class _PILOnly:
    """A dataset's __getitem__ alone, so that the BatchLoader decodes with
    PIL per item instead of taking `get_batch`."""

    def __init__(self, dataset):
        self._ds = dataset

    def __len__(self):
        return len(self._ds)

    def __getitem__(self, i):
        return self._ds[i]


def main(argv=None, data_path=None, split=None) -> dict:
    """Prints one JSON line per loader and returns {name: batches/s}.
    `data_path` and `split` (a split dict): measure over that image folder
    instead of writing one."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n_images", type=int, default=96)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--decode_size", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n_batches", type=int, default=30)
    ap.add_argument("--step_ms", type=float, default=20.0,
                    help="simulated device step per batch")
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args(argv)

    from .data.datasets import BatchLoader, ImageFolderDataset
    from .data.native_image import NativeBatchLoader, load_decoder_lib

    with tempfile.TemporaryDirectory() as td:
        if data_path is None:
            data_path = Path(td)
            split = make_dataset(data_path, args.n_images, args.image_size)
        ds = ImageFolderDataset(data_path, split, "train",
                                image_size=args.decode_size)
        results = {"pil_batchloader": run(
            BatchLoader(_PILOnly(ds), args.batch, repeat=True, seed=0),
            args.n_batches, args.step_ms)}
        if load_decoder_lib() is not None:
            results["native_get_batch"] = run(
                BatchLoader(ds, args.batch, repeat=True, seed=0),
                args.n_batches, args.step_ms)
            loader = NativeBatchLoader(ds, args.batch, seed=0,
                                       n_threads=args.threads)
            try:
                if loader.available:
                    results["native_async_pipeline"] = run(
                        loader, args.n_batches, args.step_ms)
            finally:
                loader.close()

    base = results["pil_batchloader"]
    for name, bps in results.items():
        print(json.dumps({
            "metric": f"input pipeline {name} ({args.decode_size}px "
                      f"b{args.batch}, step {args.step_ms:.0f}ms)",
            "value": bps, "unit": "batches/sec",
            "vs_baseline": bps / base}))
    return results


if __name__ == "__main__":
    main()
