"""Create or verify the stratified uniform data split.

    python -m vqgan_tpu_torch.create_data_split --data_path data/Normal_line \\
        --output data_split.json
    python -m vqgan_tpu_torch.create_data_split --output data_split.json \\
        --data_path unused --verify

Counterpart of cli/create_data_split.py, with its flags: the split of the
`ID_1..ID_{num_users}` folders (`data.splits.create_data_split`), checked
by `verify_split` before it is written; `--verify` checks an existing
split instead and exits 1 with its problems. Reads and writes files only:
no device work.
"""

from __future__ import annotations

import argparse

from .data.splits import create_data_split, load_split, save_split, verify_split

__all__ = ["main", "parse_args"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--output", default="data_split.json")
    ap.add_argument("--num_users", type=int, default=31)
    ap.add_argument("--images_per_user_train", type=int, default=50)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--verify", action="store_true",
                    help="verify an existing split instead of creating one")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Create (or, with --verify, check) the split; returns it."""
    args = parse_args(argv)
    if args.verify:
        split = load_split(args.output)
        problems = verify_split(split)
        if problems:
            print("PROBLEMS FOUND:")
            for p in problems:
                print(f"  - {p}")
            raise SystemExit(1)
        n_train = sum(len(u["train_images"]) for u in split["users"].values())
        n_test = sum(len(u["test_images"]) for u in split["users"].values())
        print(f"split OK: {len(split['users'])} users, "
              f"{n_train} train / {n_test} test images, no overlaps")
        return split

    split = create_data_split(args.data_path, args.num_users,
                              args.images_per_user_train, args.seed)
    problems = verify_split(split)
    if problems:
        raise RuntimeError(f"the new split is not sound: {problems}")
    save_split(split, args.output)
    print(f"wrote {args.output} ({len(split['users'])} users)")
    return split


if __name__ == "__main__":
    main()
