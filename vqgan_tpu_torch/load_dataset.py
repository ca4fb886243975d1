"""Split loading smoke test and per-user summary.

    python -m vqgan_tpu_torch.load_dataset --data_root data/Normal_line \\
        --split data_split.json [--image_size 256] [--test_load]

Counterpart of cli/load_dataset.py: prints the split's users with their
train / test counts (and the GMM split's gen / class lists), the totals,
and with `--test_load` one ImageNet-normalised batch of up to 4 images
from each of the train and test subsets, with its shape, dtype and first
labels. A host-side tool: it touches no device.
"""

from __future__ import annotations

import argparse

__all__ = ["main"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--split", required=True)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--test_load", action="store_true")
    args = ap.parse_args(argv)

    from .data import BatchLoader, ImageFolderDataset, load_split

    split = load_split(args.split)
    print(f"split: {len(split['users'])} users "
          f"(method: {split.get('metadata', {}).get('method', '?')})")
    total_train = total_test = 0
    for user, info in sorted(split["users"].items(),
                             key=lambda kv: int(kv[0].split("_")[1])):
        n_train = len(info.get("train_images", []))
        n_test = len(info.get("test_images", []))
        extra = ""
        if "gen_train_images" in info:
            extra = (f" (gen {len(info['gen_train_images'])}, class "
                     f"{len(info.get('class_train_images', []))})")
        print(f"  {user}: train {n_train}, test {n_test}{extra}")
        total_train += n_train
        total_test += n_test
    print(f"total: {total_train} train / {total_test} test")

    if args.test_load:
        for subset in ("train", "test"):
            ds = ImageFolderDataset(args.data_root, split, subset,
                                    image_size=args.image_size,
                                    imagenet_norm=True)
            loader = BatchLoader(ds, batch_size=min(4, len(ds)),
                                 shuffle=False, drop_last=False)
            batches = iter(loader)
            images, labels = next(batches)
            batches.close()  # stops the loader's thread
            print(f"{subset}: batch images {images.shape} "
                  f"dtype={images.dtype}, labels {labels[:4].tolist()}")
        print("smoke load OK")


if __name__ == "__main__":
    main()
