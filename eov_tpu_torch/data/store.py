"""Feature store: sharded on-disk clip-feature cache with JSON manifests.

Counterpart of ``eov_tpu/data/store.py:FeatureStore``, with the SAME
on-disk format, so a store written by either package loads in the other:

    root/manifest.json          writer 0 {"class_names": [...], "videos":
                                {vid: {"label": int, "shard": str}},
                                "dtype": "float32"|"float16", "quant": ...}
    root/manifest.pN.json       manifest of writer N > 0
    root/shard_pNNN_MMMMM.npz   {vid: feature[D], ...}

Every flush writes a new shard and atomically replaces the writer's own
manifest, so an interrupted extraction resumes from ``done_ids()``. Reads
merge every writer's manifest. ``dtype`` (on-disk feature dtype) and
``quant`` (extraction-precision provenance: ``None`` for the bf16/f32
forward, ``"int8"`` for the int8 one) follow the reference's rules: a
contradicting declaration raises. An int8 store also records its
calibration (``quant_calib``: ``{conv site: act_max}``, the reference's
site names) so that classify featurizes queries with the same int8
program. ``to_table(device)`` builds the padded class-major
``FeatureTable`` of torch tensors that eval.py consumes; ``summary()`` is
``store-info``'s view. ``MemoryFeatureStore`` holds features consumed in
the same process (classify's queries).
"""

from __future__ import annotations

import glob
import json
import logging
import os
import tempfile
from typing import Sequence

import numpy as np
import torch

from eov_tpu_torch.eval import FeatureTable
from eov_tpu_torch.utils.device import resolve_device

__all__ = ["FeatureStore", "MemoryFeatureStore"]

_MANIFEST = "manifest.json"
log = logging.getLogger("eov_tpu_torch.store")


class FeatureStore:
    """Append-oriented feature cache rooted at a directory (see module doc).

    ``process_index`` names this writer (default 0). ``dtype`` None inherits
    the store's dtype (float32 for a fresh store). ``quant`` left unset
    makes no provenance claim (read-only opens).
    """

    _DTYPES = ("float32", "float16")
    _QUANT_UNSET = object()

    def __init__(self, root: str, class_names: Sequence[str] | None = None,
                 process_index: int = 0, dtype: str | None = None,
                 quant: str | None | object = _QUANT_UNSET):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.process_index = int(process_index)
        if dtype is not None and str(dtype) not in self._DTYPES:
            raise ValueError(
                f"store dtype must be one of {self._DTYPES}, got {dtype!r}")
        self._manifest_path = os.path.join(root, self._manifest_name())
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                self._manifest = json.load(f)
        else:
            self._manifest = {
                "class_names": list(class_names) if class_names else [],
                "videos": {},
            }
        if class_names is not None:
            existing = self._merged_class_names()
            if existing and list(class_names) != existing:
                raise ValueError("class_names mismatch with existing store")
            self._manifest["class_names"] = list(class_names)
        prior = self._merged_dtype()
        if dtype is not None and prior is not None and str(dtype) != prior:
            raise ValueError(f"store at {root} holds {prior} features; "
                             f"refusing to append {dtype} (one dtype per "
                             "store)")
        self.dtype = np.dtype(str(dtype) if dtype else (prior or "float32"))
        self._manifest["dtype"] = self.dtype.name
        prior_q, prior_known = self._merged_quant()
        if quant is not self._QUANT_UNSET:
            qv = None if quant in (None, "off") else str(quant)
            if prior_known and prior_q != qv:
                raise ValueError(
                    f"store at {root} holds features extracted with "
                    f"quant={prior_q or 'off'}; refusing to append "
                    f"quant={qv or 'off'} features (one extraction precision "
                    "per store — re-extract into a fresh --store)")
            if not prior_known and self._merged_videos():
                # Provenance cannot vouch for clips it did not see written.
                log.warning(
                    "store %s already holds %d clips of unknown extraction "
                    "precision; the quant=%s declaration is NOT recorded",
                    root, len(self._merged_videos()), qv or "off")
            else:
                self._manifest["quant"] = qv
        elif prior_known:
            self._manifest["quant"] = prior_q
        self._pending: dict[str, tuple[np.ndarray, int]] = {}
        self._shard_count = len(glob.glob(
            os.path.join(root, f"shard_p{self.process_index:03d}_*")))

    def _manifest_name(self, pi: int | None = None) -> str:
        pi = self.process_index if pi is None else pi
        return _MANIFEST if pi == 0 else f"manifest.p{pi}.json"

    # ---- write path -------------------------------------------------------

    def put(self, video_id: str, feature, label: int) -> None:
        """Stage one clip feature (numpy or CPU tensor); durable after
        flush()."""
        if isinstance(feature, torch.Tensor):
            feature = feature.detach().cpu().numpy()
        self._pending[video_id] = (np.asarray(feature, self.dtype),
                                   int(label))

    def flush(self) -> str | None:
        """Write pending features as a new shard, then atomically update
        this writer's manifest."""
        if not self._pending:
            return None
        shard_name = (
            f"shard_p{self.process_index:03d}_{self._shard_count:05d}.npz")
        self._shard_count += 1
        np.savez(os.path.join(self.root, shard_name),
                 **{k: v[0] for k, v in self._pending.items()})
        for vid, (_, label) in self._pending.items():
            self._manifest["videos"][vid] = {"label": label,
                                             "shard": shard_name}
        self._write_manifest()
        self._pending.clear()
        return shard_name

    def _write_manifest(self) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(self._manifest, f)
        os.replace(tmp, self._manifest_path)

    # ---- read path (merged across all writers) ----------------------------

    def _all_manifests(self) -> list[dict]:
        out = [self._manifest]
        paths = [os.path.join(self.root, _MANIFEST)] + sorted(
            glob.glob(os.path.join(self.root, "manifest.p*.json")))
        for p in paths:
            if os.path.basename(p) == self._manifest_name():
                continue  # own manifest: the in-memory copy is newer
            if os.path.exists(p):
                with open(p) as f:
                    out.append(json.load(f))
        return out

    def _merged_class_names(self) -> list[str]:
        names: list[str] = []
        for m in self._all_manifests():
            cn = m.get("class_names") or []
            if cn:
                if names and cn != names:
                    raise ValueError(
                        f"writers disagree on class_names in {self.root}")
                names = cn
        return names

    def _merged_dtype(self) -> str | None:
        dt = None
        for m in self._all_manifests():
            d = m.get("dtype")
            if d:
                if dt is not None and d != dt:
                    raise ValueError(
                        f"writers disagree on feature dtype in {self.root}")
                dt = d
        return dt

    def _merged_quant(self) -> tuple[str | None, bool]:
        """(declared extraction precision, whether any writer declared)."""
        q, known = None, False
        for m in self._all_manifests():
            if "quant" not in m:
                continue
            if known and m["quant"] != q:
                raise ValueError(
                    f"writers disagree on extraction quant in {self.root}")
            q, known = m["quant"], True
        return q, known

    def recorded_quant(self) -> tuple[str | None, bool]:
        return self._merged_quant()

    def set_quant_calib(self, act_max: dict) -> None:
        """Record the int8 calibration this store's features were extracted
        with ({conv site: float}); written to the manifest at once."""
        self._manifest["quant_calib"] = {str(k): float(v)
                                         for k, v in act_max.items()}
        self._write_manifest()

    def quant_calib(self) -> dict | None:
        """The recorded int8 calibration, or None. Writers must agree."""
        calib = None
        for m in self._all_manifests():
            c = m.get("quant_calib")
            if c is None:
                continue
            if calib is not None and c != calib:
                raise ValueError(
                    f"writers disagree on quant_calib in {self.root}")
            calib = c
        return calib

    def _merged_videos(self) -> dict[str, dict]:
        videos: dict[str, dict] = {}
        for m in self._all_manifests():
            videos.update(m.get("videos", {}))
        return videos

    @property
    def class_names(self) -> list[str]:
        return self._merged_class_names()

    def done_ids(self) -> set[str]:
        """Clip ids already durably extracted by any writer (resume)."""
        return set(self._merged_videos())

    def load_all(self) -> dict[str, tuple[np.ndarray, int]]:
        """vid -> (float32 feature, label) for every durable clip."""
        videos = self._merged_videos()
        by_shard: dict[str, list[str]] = {}
        for vid, meta in videos.items():
            by_shard.setdefault(meta["shard"], []).append(vid)
        out = {}
        for shard, vids in by_shard.items():
            with np.load(os.path.join(self.root, shard)) as z:
                for vid in vids:
                    out[vid] = (z[vid].astype(np.float32, copy=False),
                                int(videos[vid]["label"]))
        return out

    def summary(self) -> dict:
        """Merged multi-writer summary (``store-info``), the reference's
        keys: clips, classes, feature_dim, dtype, quant, quant_calib (are
        scales recorded), shards, writers, bytes, per-class min/max and
        empty classes."""
        videos = self._merged_videos()
        shards = sorted(glob.glob(os.path.join(self.root, "shard_*.npz")))
        manifests = glob.glob(os.path.join(self.root, "manifest*.json"))
        labels = [v["label"] for v in videos.values()]
        n_classes = max(len(self.class_names),
                        (max(labels) + 1) if labels else 0)
        per_class = (np.bincount(labels, minlength=n_classes) if labels
                     else np.zeros(n_classes, np.int64))
        dim = None
        if videos:
            vid = next(iter(videos))
            with np.load(os.path.join(self.root,
                                      videos[vid]["shard"])) as z:
                dim = int(z[vid].shape[-1])
        q, known = self._merged_quant()
        return {
            "store": self.root,
            "clips": len(videos),
            "classes": n_classes,
            "feature_dim": dim,
            "dtype": self.dtype.name,
            "quant": (q or "off") if known else "unknown",
            "quant_calib": self.quant_calib() is not None,
            "shards": len(shards),
            "writers": len(manifests) or 1,
            "bytes": int(sum(os.path.getsize(p) for p in shards)),
            "clips_per_class_min":
                int(per_class.min()) if len(per_class) else 0,
            "clips_per_class_max":
                int(per_class.max()) if len(per_class) else 0,
            "empty_classes": int((per_class == 0).sum()),
        }

    def to_table(self, device: torch.device | str = "cuda",
                 n_classes: int | None = None) -> FeatureTable:
        """Padded class-major [C, M, D] features + [C] counts on device;
        ``n_classes`` pads the class axis (classes with no clips: count 0)."""
        data = self.load_all()
        if not data:
            raise ValueError(f"empty feature store: {self.root}")
        return _table_from_dict(data, resolve_device(device), n_classes)


class MemoryFeatureStore:
    """In-process stand-in for ``FeatureStore`` (put/flush/done_ids and
    load_all) for features consumed in the same run, as classify's queries
    are: nothing is written, nothing resumes."""

    def __init__(self, class_names: Sequence[str] | None = None):
        self.class_names = list(class_names) if class_names else []
        self._data: dict[str, tuple[np.ndarray, int]] = {}

    def put(self, video_id: str, feature, label: int) -> None:
        if isinstance(feature, torch.Tensor):
            feature = feature.detach().cpu().numpy()
        self._data[str(video_id)] = (np.asarray(feature, np.float32),
                                     int(label))

    def flush(self) -> None:
        return None

    def done_ids(self) -> set[str]:
        return set(self._data)

    def load_all(self) -> dict[str, tuple[np.ndarray, int]]:
        return dict(self._data)


def _table_from_dict(data: dict[str, tuple[np.ndarray, int]],
                    device: torch.device,
                    n_classes: int | None = None) -> FeatureTable:
    """{vid: (feature, label)} -> FeatureTable, slots in sorted-id order."""
    labels = [label for _, label in data.values()]
    c = n_classes or (max(labels) + 1)
    per_class: list[list[np.ndarray]] = [[] for _ in range(c)]
    for vid in sorted(data):
        feat, label = data[vid]
        per_class[label].append(feat)
    d = next(iter(data.values()))[0].shape[-1]
    m = max(1, max(len(p) for p in per_class))
    feats = np.zeros((c, m, d), np.float32)
    counts = np.zeros((c,), np.int64)
    for ci, plist in enumerate(per_class):
        for mi, f in enumerate(plist):
            feats[ci, mi] = f
        counts[ci] = len(plist)
    return FeatureTable(torch.from_numpy(feats).to(device),
                        torch.from_numpy(counts).to(device))
