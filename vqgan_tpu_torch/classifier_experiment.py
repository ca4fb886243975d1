"""Downstream classifier experiment: per-user identification accuracy,
with and without synthetic images.

    python -m vqgan_tpu_torch.classifier_experiment --data_root data \\
        --split data_split.json --synthetic_folder generated --multi_seed

Counterpart of cli/classifier_experiment.py, with its flags: ResNet18 from
scratch on the split's real class-train images (ImageNet-normalised),
optionally with every image of a synthetic folder of `ID_x` folders
(`--user_filter`: the 0-based labels to take from it), evaluated on the
split's test images; per-user accuracy and the over-confidence warnings
are printed and the results written to `--output` as JSON.
`--multi_seed` runs seeds {6, 42, 888} and writes their aggregate.

Runs on the GPU by default (`--device cpu` to run on the CPU), with TF32
off for fp32 matmuls and convolutions.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from .data import ImageFolderDataset, SyntheticDataset, load_split
from .device import resolve_device, set_full_fp32_precision
from .eval.classifier import ClassifierExperiment, run_multi_seed

__all__ = ["main", "parse_args"]


class _Concat:
    """The items of several datasets, one after another."""

    def __init__(self, *datasets):
        self.datasets = datasets
        self.offsets = []
        total = 0
        for d in datasets:
            self.offsets.append(total)
            total += len(d)
        self.total = total

    def __len__(self):
        return self.total

    def __getitem__(self, i):
        for d, off in zip(reversed(self.datasets), reversed(self.offsets)):
            if i >= off:
                return d[i - off]
        raise IndexError(i)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--split", required=True)
    ap.add_argument("--synthetic_folder", default=None)
    ap.add_argument("--user_filter", type=int, nargs="*", default=None,
                    help="0-based labels to include from synthetic data")
    ap.add_argument("--num_classes", type=int, default=31)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--multi_seed", action="store_true",
                    help="run seeds {6, 42, 888} and aggregate")
    ap.add_argument("--output", default="./classifier_results/results.json")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Returns {"results": what --output holds, "experiment": the trained
    ClassifierExperiment (None with --multi_seed)}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_full_fp32_precision()
    split = load_split(args.split)

    def make_train():
        real = ImageFolderDataset(args.data_root, split, "class_train",
                                  image_size=args.image_size,
                                  imagenet_norm=True)
        if args.synthetic_folder:
            synth = SyntheticDataset(args.synthetic_folder,
                                     image_size=args.image_size,
                                     imagenet_norm=True,
                                     user_filter=args.user_filter)
            print(f"augmenting {len(real)} real with {len(synth)} synthetic")
            return _Concat(real, synth)
        return real

    def make_test():
        return ImageFolderDataset(args.data_root, split, "test",
                                  image_size=args.image_size,
                                  imagenet_norm=True)

    kwargs = dict(num_classes=args.num_classes, lr=args.lr,
                  epochs=args.epochs, batch_size=args.batch_size,
                  device=device)

    if args.multi_seed:
        summary = run_multi_seed(make_train, make_test,
                                 output_path=args.output, **kwargs)
        return {"results": summary, "experiment": None}

    exp = ClassifierExperiment(seed=args.seed, **kwargs)
    exp.train(make_train())
    res = exp.evaluate(make_test())
    print(f"test accuracy: {res['accuracy']:.4f}")
    for c, a in sorted(res["per_class_accuracy"].items()):
        print(f"  ID_{c + 1}: {a:.3f}")
    for w in res["warnings"]:
        print(f"  [warn] {w}")
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=2))
    print(f"saved -> {out}")
    return {"results": res, "experiment": exp}


if __name__ == "__main__":
    main()
