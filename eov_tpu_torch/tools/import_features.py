"""Import a reference-era feature cache into a FeatureStore.

Counterpart of ``eov_tpu/tools/import_features.py``: a user who already
owns a cache of clip features should not have to extract again to run
``eval``/``classify`` on it. The layouts it reads:

  1. class-directory tree:  src/ClassName/video_id.npy
     -> label = index of ClassName (sorted order, or the --classes order)
  2. flat .npy directory:   src/video_id.npy  + --split list.txt
     -> label from the TSN split line whose path basename is video_id
  3. one dict file: .npz; .pt/.pth saved by torch (loaded with
     ``weights_only=True`` first, a full unpickle only behind
     --allow-pickle); .pkl/.pickle behind --allow-pickle.
     {video_id: feature[D]} + --split, or {class_name: [feat...] | [N, D]}
     (class-keyed when there is no --split and every value is 2-D or a
     list)

Every route checks that the feature dims agree and refuses ambiguity
(mixed layouts, ids missing from the split, duplicate ids, features that
are not 1-D or not finite) with a message that names the fix: a store
must never hold wrong labels, because eval would still run on them. All
of it is checked before the store is created, and a failure while writing
removes the store again, so no partial store is left behind.

    python -m eov_tpu_torch.tools.import_features --src CACHE --store OUT \\
        [--split list.txt] [--classes classes.txt] [--store-dtype float16]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
from typing import Mapping, Sequence

import numpy as np

__all__ = ["import_cache", "main"]

_FLUSH_EVERY = 1024  # clips per shard

# Extensions stripped when a split-line path or a feature file name becomes
# a video id: split lists name source videos ('Class/v_x.avi'), the cache
# holds 'v_x.npy', and both must give 'v_x'.
_ID_EXTS = frozenset(
    {".npy", ".pt", ".pth", ".avi", ".mp4", ".mkv", ".mov", ".webm", ".mpg"})


def _basename_id(path: str) -> str:
    """Video id of a split-line path or a feature file name."""
    b = os.path.basename(path.rstrip("/"))
    stem, ext = os.path.splitext(b)
    return stem if ext.lower() in _ID_EXTS else b


def _split_label_map(split_path: str) -> dict[str, int]:
    from eov_tpu_torch.data.datasets import load_split_txt

    out: dict[str, int] = {}
    for p, _n, label in load_split_txt(split_path):
        vid = _basename_id(p)
        if vid in out and out[vid] != label:
            raise ValueError(
                f"split file maps video id {vid!r} to two labels "
                f"({out[vid]} and {label}); ids must be unique after "
                "basename normalization")
        out[vid] = label
    return out


def _check_feature(vid: str, feat: np.ndarray, dim: int | None) -> int:
    feat = np.asarray(feat)
    if feat.ndim != 1:
        raise ValueError(
            f"feature for {vid!r} has shape {feat.shape}; per-video clip "
            "features must be 1-D (TSN consensus already applied). A "
            "[K, D] per-segment array should be mean-pooled first.")
    if dim is not None and feat.shape[0] != dim:
        raise ValueError(
            f"feature dim mismatch: {vid!r} is {feat.shape[0]}-d but "
            f"earlier features are {dim}-d — mixed caches cannot share a "
            "store")
    if not np.all(np.isfinite(feat)):
        raise ValueError(f"feature for {vid!r} contains NaN/Inf")
    return int(feat.shape[0])


def _iter_class_tree(src: str):
    """Layout 1: (class_name, video_id, npy_path) over src/Class/vid.npy."""
    for cname in sorted(d for d in os.listdir(src)
                        if os.path.isdir(os.path.join(src, d))):
        for fn in sorted(os.listdir(os.path.join(src, cname))):
            if fn.endswith(".npy"):
                yield cname, _basename_id(fn), os.path.join(src, cname, fn)


def _to_numpy(v):
    """A cache value (tensor, array, or a list of either) as numpy."""
    if isinstance(v, (list, tuple)):
        return type(v)(_to_numpy(x) for x in v)
    if hasattr(v, "detach") and hasattr(v, "numpy"):  # a torch.Tensor
        return v.detach().cpu().numpy()
    return v


def _load_torch_dict(src: str, allow_pickle: bool) -> Mapping:
    """A ``torch.save``'d feature dict: torch's restricted unpickler
    (tensors and containers only) first; a payload it rejects needs
    --allow-pickle for the full unpickle, as a .pkl does."""
    import torch

    try:
        d = torch.load(src, map_location="cpu", weights_only=True)
    except Exception:
        if not allow_pickle:
            raise ValueError(
                f"{src!r} is not loadable with torch's safe restricted "
                "unpickler (weights_only=True); a full torch.load executes "
                "arbitrary code — pass --allow-pickle only for files you "
                "trust") from None
        d = torch.load(src, map_location="cpu", weights_only=False)
    if not isinstance(d, Mapping):
        raise ValueError(
            f"torch cache must hold a dict keyed by video id or class "
            f"name, got {type(d).__name__}")
    return {str(k): _to_numpy(v) for k, v in d.items()}


def _load_dict(src: str, allow_pickle: bool) -> Mapping[str, np.ndarray]:
    if src.endswith(".npz"):
        with np.load(src, allow_pickle=False) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    if src.endswith((".pt", ".pth")):
        return _load_torch_dict(src, allow_pickle)
    if src.endswith((".pkl", ".pickle")):
        if not allow_pickle:
            raise ValueError(
                "pickle caches execute arbitrary code on load; pass "
                "--allow-pickle only for files you trust")
        import pickle

        with open(src, "rb") as f:
            d = pickle.load(f)
        if not isinstance(d, Mapping):
            raise ValueError(
                f"pickle cache must hold a dict, got {type(d).__name__}")
        return {k: _to_numpy(v) for k, v in d.items()}
    raise ValueError(
        f"unrecognized cache file {src!r}: expected .npz, .pt/.pth, .pkl, "
        "or a directory")


def _collect(src: str, split: str | None, allow_pickle: bool) -> list:
    """[(video_id, feature, class name or None)] of the cache at src."""
    items: list[tuple[str, np.ndarray, object]] = []
    if os.path.isdir(src):
        tree = list(_iter_class_tree(src))
        flat = sorted(fn for fn in os.listdir(src) if fn.endswith(".npy")
                      and os.path.isfile(os.path.join(src, fn)))
        if tree and flat:
            raise ValueError(
                f"{src!r} mixes class subdirectories and top-level .npy "
                "files; import each layout from its own root")
        if tree:
            return [(vid, np.load(path), cname) for cname, vid, path in tree]
        if not flat:
            raise ValueError(f"no .npy features found under {src!r}")
        if not split:
            raise ValueError(
                "flat .npy directory carries no labels; pass --split "
                "list.txt (TSN `<path> <frames> <label>` lines) to map "
                "video ids to labels")
        return [(_basename_id(fn), np.load(os.path.join(src, fn)), None)
                for fn in flat]
    d = _load_dict(src, allow_pickle)
    if not d:
        raise ValueError(f"cache {src!r} is empty")
    # With --split the dict is keyed by video id; without it, values that
    # are all 2-D (or lists of rows) mean class-keyed. A video-keyed dict
    # of [K, D] arrays without --split would otherwise turn its video ids
    # into class names.
    class_keyed = split is None and all(
        (isinstance(v, (list, tuple)) and v)
        or (isinstance(v, np.ndarray) and v.ndim == 2) for v in d.values())
    if class_keyed:
        for cname, rows in d.items():
            rows = rows if isinstance(rows, np.ndarray) else list(rows)
            items += [(f"{cname}/{i:05d}", np.asarray(f), cname)
                      for i, f in enumerate(rows)]
        return items
    if not split:
        raise ValueError(
            "dict cache keyed by video id carries no labels; pass --split "
            "list.txt, or key the dict by class name with [N, D] arrays per "
            "class")
    # Keys normalize as split-line ids do ('Class/v_x.avi' -> 'v_x'); the
    # duplicate-id refusal catches a collision this could make.
    return [(_basename_id(str(vid)), np.asarray(f), None)
            for vid, f in d.items()]


def import_cache(src: str, store_root: str, *, split: str | None = None,
                 class_names: Sequence[str] | None = None,
                 store_dtype: str | None = None, allow_pickle: bool = False,
                 quant: str | None = None) -> dict:
    """Convert the cache at ``src`` into a new FeatureStore at
    ``store_root``; returns the store's ``summary()``. Refuses
    (``ValueError``) any ambiguity rather than guess (module doc).

    ``quant`` declares the cache's known extraction precision ("off" = the
    float forward, "int8"); the default makes no claim and leaves the
    store's provenance unknown."""
    from eov_tpu_torch.data.store import FeatureStore

    if os.path.exists(os.path.join(store_root, "manifest.json")):
        raise ValueError(
            f"store {store_root!r} already exists; import into a fresh "
            "directory (appending imported features to an extracted store "
            "would mix feature provenances silently)")
    items = _collect(src, split, allow_pickle)

    tree_classes = sorted({c for _, _, c in items if c is not None})
    if tree_classes:
        names = list(class_names) if class_names else tree_classes
        missing = [c for c in tree_classes if c not in names]
        if missing:
            raise ValueError(
                f"--classes list is missing cache classes {missing[:4]} "
                f"(+{max(0, len(missing) - 4)} more)")
        resolved = [(vid, feat, names.index(c)) for vid, feat, c in items]
    else:
        labels = _split_label_map(split)
        unmatched = [vid for vid, _, _ in items if vid not in labels]
        if unmatched:
            raise ValueError(
                f"{len(unmatched)} cache video ids not in the split file, "
                f"e.g. {unmatched[:4]} — ids are matched by basename "
                "without extension")
        resolved = [(vid, feat, labels[vid]) for vid, feat, _ in items]
        max_label = max(label for _, _, label in resolved)
        names = list(class_names) if class_names else []
        if names and len(names) <= max_label:
            raise ValueError(
                f"--classes lists {len(names)} names but the split uses "
                f"label {max_label}")
        names = names or [f"class_{i:03d}" for i in range(max_label + 1)]

    # A duplicate id would overwrite in the store: one clip imported with
    # another's label.
    seen: set[str] = set()
    dupes = sorted({vid for vid, _, _ in resolved
                    if vid in seen or seen.add(vid)})
    if dupes:
        raise ValueError(
            f"{len(dupes)} video ids appear more than once in the cache, "
            f"e.g. {dupes[:4]} — ids must be unique across classes after "
            "basename/extension normalization (rename the colliding files)")
    dim: int | None = None
    for vid, feat, _ in resolved:
        dim = _check_feature(vid, feat, dim)

    store_kw = {} if quant is None else {
        "quant": None if quant == "off" else quant}
    # What was there before this call (a missing or an empty root is the
    # usual case); a failure removes only what the call added.
    before = set(os.listdir(store_root)) if os.path.isdir(store_root) \
        else None
    try:
        store = FeatureStore(store_root, class_names=names, process_index=0,
                             dtype=store_dtype, **store_kw)
        for n_done, (vid, feat, label) in enumerate(resolved, 1):
            store.put(vid, np.asarray(feat, np.float32), label)
            if n_done % _FLUSH_EVERY == 0:
                store.flush()
        store.flush()
    except BaseException:
        if before is None:
            shutil.rmtree(store_root, ignore_errors=True)
        else:
            for name in set(os.listdir(store_root)) - before:
                path = os.path.join(store_root, name)
                if os.path.isdir(path) and not os.path.islink(path):
                    shutil.rmtree(path, ignore_errors=True)
                else:
                    with contextlib.suppress(OSError):
                        os.remove(path)
        raise
    return store.summary()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("import_features", description=__doc__)
    ap.add_argument("--src", required=True,
                    help="cache: class-tree dir, flat .npy dir, .npz, "
                         ".pt/.pth (a torch.save'd dict), .pkl")
    ap.add_argument("--store", required=True, help="output store (fresh dir)")
    ap.add_argument("--split", default=None,
                    help="TSN split txt mapping video ids to labels "
                         "(required for flat and video-id-keyed caches)")
    ap.add_argument("--classes", default=None,
                    help="class-names txt (one per line) fixing label order")
    ap.add_argument("--store-dtype", default=None,
                    choices=("float32", "float16"))
    ap.add_argument("--allow-pickle", action="store_true",
                    help="permit full unpickling (.pkl, and .pt/.pth that "
                         "the restricted loader rejects): arbitrary code "
                         "runs on load, so trusted files only")
    ap.add_argument("--quant", default=None, choices=("off", "int8"),
                    help="declare the cache's KNOWN extraction precision so "
                         "the store carries provenance; omit when unsure")
    args = ap.parse_args(argv)
    names = None
    if args.classes:
        from eov_tpu_torch.data.class_splits import load_class_list

        names = load_class_list(args.classes)
    try:
        summary = import_cache(
            args.src, args.store, split=args.split, class_names=names,
            store_dtype=args.store_dtype, allow_pickle=args.allow_pickle,
            quant=args.quant)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
