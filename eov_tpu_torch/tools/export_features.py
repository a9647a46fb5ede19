"""Export a FeatureStore to the reference-era cache layouts.

Counterpart of ``eov_tpu/tools/export_features.py`` (the inverse of
``tools/import_features.py``): hand a store's features to per-video
``.npy`` readers or to any notebook without a store reader.

  tree (default):  out/ClassName/video_id.npy   (one 1-D float32 each)
  npz:             out.npz  {video_id: feature[D]}  + out.labels.json
                   ({video_id: {label, class_name}}; the flat dict would
                   lose the labels otherwise)

Features are written as float32 whatever the store's on-disk dtype. A
store without class names exports its labels as ``class_NNN``
directories, which ``import_features`` reads back. A ``/`` in a video id
becomes ``_`` in the tree; two ids that would then share a file are
refused before anything is written.

    python -m eov_tpu_torch.tools.export_features --store S --out DIR \\
        [--format tree|npz]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

__all__ = ["export_store", "main"]


def export_store(store_root: str, out: str, *, fmt: str = "tree") -> dict:
    """Write every clip of the store at ``store_root`` to ``out``. Returns
    {"clips", "classes", "format", "out"}."""
    from eov_tpu_torch.data.store import FeatureStore

    if fmt not in ("tree", "npz"):
        raise ValueError(f"format must be 'tree' or 'npz', got {fmt!r}")
    store = FeatureStore(store_root, process_index=0)
    data = store.load_all()
    if not data:
        raise ValueError(f"empty feature store: {store_root}")
    names = store.class_names
    max_label = max(label for _, label in data.values())
    names = names + [f"class_{i:03d}"
                     for i in range(len(names), max_label + 1)]

    if fmt == "tree":
        if os.path.exists(out) and os.listdir(out):
            raise ValueError(
                f"output dir {out!r} is not empty; export into a fresh "
                "directory (mixing exports corrupts the class tree the "
                "importer reads back)")
        written: dict[str, str] = {}
        for vid in sorted(data):
            fname = os.path.join(names[data[vid][1]], vid.replace("/", "_"))
            if fname in written:
                raise ValueError(
                    f"video ids {written[fname]!r} and {vid!r} both map to "
                    f"{fname + '.npy'!r} after '/'→'_' mangling; rename one "
                    "so the exported tree keeps every clip")
            written[fname] = vid
        for fname, vid in written.items():
            path = os.path.join(out, fname + ".npy")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, data[vid][0].astype(np.float32, copy=False))
    else:
        base = out[:-4] if out.endswith(".npz") else out
        np.savez(base + ".npz", **{vid: f.astype(np.float32, copy=False)
                                   for vid, (f, _) in data.items()})
        with open(base + ".labels.json", "w") as f:
            json.dump({vid: {"label": label, "class_name": names[label]}
                       for vid, (_, label) in data.items()}, f)
    return {"clips": len(data),
            "classes": len({label for _, label in data.values()}),
            "format": fmt, "out": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("export_features", description=__doc__)
    ap.add_argument("--store", required=True, help="source feature store")
    ap.add_argument("--out", required=True,
                    help="output dir (tree) or .npz path (npz)")
    ap.add_argument("--format", default="tree", choices=("tree", "npz"))
    args = ap.parse_args(argv)
    try:
        summary = export_store(args.store, args.out, fmt=args.format)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
