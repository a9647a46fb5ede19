"""Class-level one-shot split metadata.

Counterpart of ``eov_tpu/data/class_splits.py``. One-shot video protocols
split by class: meta-train, meta-val and meta-test are disjoint class sets.
The checked-in documents are ``eov_tpu_torch/splits/*.json`` (copies of the
reference's ``eov_tpu/splits/``), and ``make_class_split`` generates one
reproducibly from any class list.

Protocols:
* Kinetics-100 CMN: 64 train / 12 val / 24 test classes, 100 clips each;
  the published class lists are a drop-in (``load_class_split`` reads them
  unchanged), the generator fills the protocol's shape from any list.
* UCF101 one-shot: 70/10/21 classes over the canonical 101 class names
  (``splits/ucf101_classes.txt``).

Format (splits/*.json):
    {"protocol": "...", "class_splits": {"train": [...], "val": [...],
     "test": [...]}}
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping, Sequence

import numpy as np

from eov_tpu_torch.data.datasets import get_batch_accepts_out

__all__ = [
    "SPLITS_DIR",
    "load_class_list",
    "make_class_split",
    "load_class_split",
    "save_class_split",
    "filter_split_by_classes",
    "filter_dataset_by_classes",
]

SPLITS_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "splits")


def load_class_list(path: str) -> list[str]:
    """One class name per line; blank lines and ``#`` comments ignored."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                out.append(line)
    return out


def make_class_split(
    class_names: Sequence[str],
    n_train: int,
    n_val: int,
    n_test: int,
    *,
    seed: int = 0,
    protocol: str = "custom",
) -> dict:
    """Deterministic disjoint class split (seeded permutation).

    The permutation is over the case-sensitively sorted class list, so the
    result depends only on (class set, counts, seed) — not input order.
    """
    names = sorted(set(class_names))
    if n_train + n_val + n_test != len(names):
        raise ValueError(
            f"{n_train}+{n_val}+{n_test} != {len(names)} classes"
        )
    perm = np.random.default_rng(seed).permutation(len(names))
    shuffled = [names[i] for i in perm]
    return {
        "protocol": protocol,
        "seed": seed,
        "class_splits": {
            "train": sorted(shuffled[:n_train]),
            "val": sorted(shuffled[n_train : n_train + n_val]),
            "test": sorted(shuffled[n_train + n_val :]),
        },
    }


def save_class_split(path: str, split: Mapping) -> None:
    with open(path, "w") as f:
        json.dump(dict(split), f, indent=1, sort_keys=True)
        f.write("\n")


def load_class_split(path: str) -> dict:
    """Load + validate a class split document (disjointness, non-empty)."""
    with open(path) as f:
        doc = json.load(f)
    splits = doc["class_splits"]
    seen: set[str] = set()
    for name, classes in splits.items():
        if not classes:
            raise ValueError(f"empty class split: {name} in {path}")
        dup = seen.intersection(classes)
        if dup:
            raise ValueError(f"classes in multiple splits: {sorted(dup)}")
        seen.update(classes)
    return doc


def filter_split_by_classes(
    split: Sequence[tuple[str, int, int]],
    class_names: Sequence[str],
    keep: Sequence[str],
) -> tuple[list[tuple[str, int, int]], list[str]]:
    """Restrict a video split list to the given classes, relabeled densely.

    Returns (filtered split with labels 0..len(keep)-1, kept class names in
    new label order). This is the bridge from a class-level one-shot split
    to the per-video lists extract/eval consume.
    """
    keep_sorted = sorted(keep)
    remap = {class_names.index(c): i for i, c in enumerate(keep_sorted)}
    out = [
        (p, n, remap[l]) for p, n, l in split if l in remap
    ]
    return out, keep_sorted


class _ClassFilteredDataset:
    """VideoDataset view restricted to a class subset, labels re-densified."""

    def __init__(self, base, keep: Sequence[str]):
        self._base = base
        self.class_names = sorted(keep)
        remap = {
            list(base.class_names).index(c): i
            for i, c in enumerate(self.class_names)
        }
        self.records = [
            dataclasses.replace(r, label=remap[r.label])
            for r in base.records
            if r.label in remap
        ]
        # Expose a pooled get_batch ONLY when the base has one: consumers
        # feature-detect with hasattr (extract.py's can_pool), and a
        # class-level method that raises at call time would make every
        # batch pay a failed pooled attempt + warning before the
        # per-record fallback. The wrapper also mirrors the base's `out=`
        # support in its own signature — extract.py introspects for it,
        # and advertising `out=` over an out-less base would turn every
        # pooled call into a TypeError + per-record retry.
        if hasattr(base, "get_batch"):
            base_out = get_batch_accepts_out(base.get_batch)
            if base_out is None:  # unknown: mirror unknown (see below)
                self.get_batch = _SignatureOpaque(base.get_batch)
            elif base_out:
                self.get_batch = self._pooled_get_batch
            else:
                self.get_batch = self._pooled_get_batch_no_out

    def get_frames(self, record, indices):
        return self._base.get_frames(record, indices)

    def _pooled_get_batch(self, records, indices, out=None):
        return self._base.get_batch(records, indices, out=out)

    def _pooled_get_batch_no_out(self, records, indices):
        return self._base.get_batch(records, indices)


class _SignatureOpaque:
    """Passthrough for a base ``get_batch`` whose ``out=`` support is
    UNKNOWN (its signature is un-introspectable — a C callable). This
    wrapper is deliberately un-introspectable too, so consumers apply the
    same probe-and-settle policy to the filtered view they would apply to
    the base directly — extract.py owns that policy, its logging, and the
    buffer-ring handoff. Settling inside the wrapper instead would (a)
    mis-settle out-less on a genuine TypeError raised INSIDE an
    out-accepting base, silently and unloggably, and (b) leave an
    out-accepting stable signature over a settled-out-less base, so the
    consumer keeps cycling ring buffers the wrapper discards every batch.
    """

    def __init__(self, fn):
        self._fn = fn

    @property
    def __signature__(self):
        raise ValueError("base get_batch signature is un-introspectable")

    def __call__(self, records, indices, *args, **kwargs):
        return self._fn(records, indices, *args, **kwargs)


def filter_dataset_by_classes(dataset, keep: Sequence[str]):
    """Wrap any VideoDataset, keeping only `keep` classes (dense labels).

    The label remap matches filter_split_by_classes; pooled get_batch passes
    through when the base dataset has one (record labels aren't used by the
    loaders, so relabeled records load correctly).
    """
    return _ClassFilteredDataset(dataset, keep)
