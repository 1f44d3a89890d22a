"""Build the {train,val,test}.txt split lists for a Sat2Aer-layout dataset,
as ``srcgan_tpu.cli.prepare_data`` (the same lists for the same seed).

The training and eval tools read these lists next to ``src/`` and ``tar/``.
Given a dataset directory containing paired images::

    dataset/<root>/src/*.png      degraded / source-domain patches
    dataset/<root>/tar/*.png      target-domain patches (same filenames)

it writes deterministic, disjoint ``train.txt`` / ``val.txt`` / ``test.txt``
(and ``all.txt``) file lists::

    python -m srcgan_tpu_torch.cli.prepare_data --dir dataset/Sat2Aerx1 \
        --val 0.1 --test 0.1 --seed 0

Only names present in BOTH ``src/`` and ``tar/`` are listed; unpaired files
are reported and skipped.  Existing lists are never overwritten without
``--force``.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def paired_names(root_dir: str):
    """(paired, src_only, tar_only) sorted filename lists under root_dir."""
    def listing(sub):
        d = os.path.join(root_dir, sub)
        if not os.path.isdir(d):
            raise FileNotFoundError(f"{d} is not a directory (expected the "
                                    "Sat2Aer layout: <dir>/src + <dir>/tar)")
        return {f for f in os.listdir(d)
                if f.lower().endswith(IMAGE_EXTS)}

    src, tar = listing("src"), listing("tar")
    return (sorted(src & tar), sorted(src - tar), sorted(tar - src))


def split_names(names, val_frac: float, test_frac: float, seed: int = 0):
    """Deterministic disjoint {train, val, test} split of ``names``.

    Fractions round to the nearest count but keep at least one sample in any
    split with a non-zero fraction (so tiny datasets still get a val/test
    list the eval tools can read).
    """
    if val_frac < 0 or test_frac < 0 or val_frac + test_frac >= 1:
        raise ValueError("need 0 <= val, test and val + test < 1")
    order = np.array(names)
    np.random.default_rng(seed).shuffle(order)
    n = len(order)

    def count(frac):
        return min(max(1, round(n * frac)), n - 1) if frac > 0 and n > 1 else 0

    n_val, n_test = count(val_frac), count(test_frac)
    if n_val + n_test >= n:  # tiny dataset: train keeps at least one
        n_test = max(0, n - 1 - n_val)
    return {"train": sorted(order[n_val + n_test:].tolist()),
            "val": sorted(order[:n_val].tolist()),
            "test": sorted(order[n_val:n_val + n_test].tolist())}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dir", required=True,
                   help="dataset root containing src/ and tar/")
    p.add_argument("--val", type=float, default=0.1,
                   help="validation fraction (default 0.1)")
    p.add_argument("--test", type=float, default=0.1,
                   help="test fraction (default 0.1)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--force", action="store_true",
                   help="overwrite existing split lists")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    paired, src_only, tar_only = paired_names(args.dir)
    for what, missing in (("tar", src_only), ("src", tar_only)):
        if missing:
            print(f"skipping {len(missing)} file(s) with no {what}/ "
                  f"counterpart: {', '.join(missing[:5])}"
                  + (" ..." if len(missing) > 5 else ""))
    if not paired:
        sys.exit(f"no paired images under {args.dir}/src + tar")

    splits = split_names(paired, args.val, args.test, args.seed)
    splits["all"] = paired
    existing = [s for s in splits
                if os.path.exists(os.path.join(args.dir, f"{s}.txt"))]
    if existing and not args.force:
        sys.exit(f"{', '.join(f'{s}.txt' for s in existing)} already "
                 f"exist(s) under {args.dir}; pass --force to overwrite")
    for split, names in splits.items():
        with open(os.path.join(args.dir, f"{split}.txt"), "w") as f:
            f.write("\n".join(names) + ("\n" if names else ""))
    print(f"{args.dir}: {len(paired)} pairs -> "
          + ", ".join(f"{s} {len(splits[s])}"
                      for s in ("train", "val", "test")))


if __name__ == "__main__":
    main()
