"""Serving-host generation: write images from a serving artifact.

    python -m vqgan_tpu_torch.serve_generate --artifact serving_artifact \\
        --output_dir generated [--user_ids 1 2 3 | --all_users] \\
        [--num_images 8] [--seed 42] [--device cuda]

Counterpart of cli/serve_generate.py: the generate.py output contract
(`ID_X/generated_###.jpg` at quality 95) from an artifact directory written
by `export_serving`, with no model code: this module imports only
`serving/`. The artifact's programs have a fixed batch size (meta.json
"batch_size"); requests are tiled into full batches and the surplus images
dropped, so any --num_images works against any artifact. Noise comes from
one `torch.Generator` seeded with --seed. Runs on the GPU by default; an
artifact exported for the CPU needs `--device cpu`.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from .serving import load_cfg_sampler

__all__ = ["main"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--artifact", required=True,
                    help="serving directory from export_serving")
    ap.add_argument("--output_dir", default="./generated")
    ap.add_argument("--user_ids", type=int, nargs="*", default=None,
                    help="1-based user ids; default all users (from meta)")
    ap.add_argument("--all_users", action="store_true")
    ap.add_argument("--num_images", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Write the images. Returns {"images": paths written,
    "batch_seconds": host seconds of each batch, sampling through the
    JPEG writes}."""
    args = parse_args(argv)
    sample = load_cfg_sampler(args.artifact, args.device)
    batch = sample.batch_size
    users = args.user_ids or list(range(1, sample.num_users + 1))
    generator = torch.Generator(device=sample.device).manual_seed(args.seed)

    written, batch_seconds = [], []
    out_root = Path(args.output_dir)
    for user in users:
        udir = out_root / f"ID_{user}"
        udir.mkdir(parents=True, exist_ok=True)
        # labels are 0-based inside the model (generate.py convention)
        classes = torch.full((batch,), user - 1, dtype=torch.long)
        n = 0
        while n < args.num_images:
            t0 = time.perf_counter()
            imgs = sample(classes, generator=generator).cpu().numpy()
            if not np.isfinite(imgs).all():
                raise FloatingPointError(f"non-finite images for ID_{user}")
            for img in imgs[:min(batch, args.num_images - n)]:
                arr = np.clip(img * 255.0, 0, 255).astype(np.uint8)
                path = udir / f"generated_{n:03d}.jpg"
                Image.fromarray(arr).save(path, quality=95)
                written.append(path)
                n += 1
            batch_seconds.append(time.perf_counter() - t0)
        print(f"ID_{user}: {n} images -> {udir}")
    print(f"done: {len(users)} users x {args.num_images} images "
          f"(artifact batch {batch})")
    return {"images": written, "batch_seconds": batch_seconds}


if __name__ == "__main__":
    main()
