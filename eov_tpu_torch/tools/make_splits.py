"""Regenerate the checked-in class splits.

Counterpart of ``eov_tpu/tools/make_splits.py``: writes
``eov_tpu_torch/splits/*.json`` deterministically from the checked-in
class lists (a given class set, counts and seed give the same bytes).
Run after editing a class list or adding a protocol:

    python -m eov_tpu_torch.tools.make_splits [--out DIR]

* ``ucf101_oneshot.json``: the UCF101 one-shot protocol, 70/10/21 classes
  of ``ucf101_classes.txt`` (seed 0).
* ``kinetics100_cmn.json``: the Kinetics-100 CMN protocol's shape,
  64/12/24 classes, written only when ``kinetics100_cmn_classes.txt`` (the
  100 CMN class names, which are not shipped) is dropped in beside it.
"""

from __future__ import annotations

import argparse
import os

from eov_tpu_torch.data import class_splits as cs

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=cs.SPLITS_DIR,
                    help="output directory (default: the package's splits/)")
    args = ap.parse_args(argv)
    d = cs.SPLITS_DIR
    os.makedirs(args.out, exist_ok=True)
    ucf = cs.load_class_list(os.path.join(d, "ucf101_classes.txt"))
    cs.save_class_split(
        os.path.join(args.out, "ucf101_oneshot.json"),
        cs.make_class_split(ucf, 70, 10, 21, seed=0,
                            protocol="ucf101_oneshot_70_10_21"))
    cmn_list = os.path.join(d, "kinetics100_cmn_classes.txt")
    if os.path.exists(cmn_list):
        cs.save_class_split(
            os.path.join(args.out, "kinetics100_cmn.json"),
            cs.make_class_split(cs.load_class_list(cmn_list), 64, 12, 24,
                                seed=0, protocol="kinetics100_cmn_64_12_24"))
    print(f"splits written under {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
