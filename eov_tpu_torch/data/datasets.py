"""Video datasets: records, the synthetic fixtures, video files, frame
folders, EOVC shards, and split files.

Counterpart of ``eov_tpu/data/datasets.py``, with the same names and
formats. Datasets are thin host-side index structures: ``get_frames``
decodes one clip's frames; the pooled ``get_batch(records, indices,
out=None)`` of the video-file and EOVC datasets decodes a whole batch,
into a caller's buffer when ``out`` is given (``extract.py`` keeps a ring
of them). Batching, decode overlap and the device transfer belong to
``extract.py``. cv2 and PIL are imported only where a frame is decoded.
Each ``get_frames`` and ``get_batch`` of the video-file, frame-folder and
EOVC datasets is a ``read`` span (``utils/trace.py``); the EOVC reader also
counts the bytes and clips it returns (``eovc.bytes``, ``eovc.clips``).
"""

from __future__ import annotations

import dataclasses
import glob
import inspect
import json
import logging
import os
from typing import Protocol, Sequence

import numpy as np

from eov_tpu_torch.data import fixtures
from eov_tpu_torch.utils import trace

__all__ = ["VideoRecord", "VideoDataset", "SyntheticVideoDataset",
           "FrameFolderDataset", "VideoFileDataset", "EovcVideoDataset",
           "get_batch_accepts_out", "load_split_txt", "save_split_txt",
           "load_split_json", "save_split_json"]

log = logging.getLogger("eov_tpu_torch.data")

@dataclasses.dataclass(frozen=True)
class VideoRecord:
    """One video: stable id, frame count, integer label."""

    video_id: str
    num_frames: int
    label: int


class VideoDataset(Protocol):
    """Minimal dataset protocol consumed by extract.py."""

    records: Sequence[VideoRecord]
    class_names: Sequence[str]

    def get_frames(self, record: VideoRecord,
                   indices: np.ndarray) -> np.ndarray:
        """uint8 [len(indices), H, W, 3] RGB frames at the given indices."""
        ...


def get_batch_accepts_out(fn) -> bool | None:
    """Does a pooled ``get_batch`` accept the ``out=`` buffer-ring kwarg?

    Single source of truth for the feature-detection rule shared by
    extract.py and data/class_splits.py (they must agree, or a filtered
    wrapper could advertise a form its base rejects). Returns None when
    the signature cannot be introspected (C callables) — the CALLER
    decides the probe policy; guessing here would either silently drop
    the buffer ring or turn every pooled call into a TypeError retry.
    """
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return None
    return "out" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
    )


class SyntheticVideoDataset:
    """Procedural fixture dataset — deterministic, no IO; the same records
    and frames as the reference's for the same arguments."""

    def __init__(self, n_classes: int = 10, clips_per_class: int = 8,
                 min_frames: int = 24, max_frames: int = 60,
                 height: int = 128, width: int = 160, seed: int = 0,
                 name: str = "synthetic", virtual: bool = False):
        self._virtual = virtual
        self.name = name
        self.height, self.width = height, width
        if virtual:
            self.class_names = [f"{name.capitalize()} Class {c:03d}"
                                for c in range(n_classes)]
        else:
            self.class_names = [f"{name}_class_{c:03d}"
                                for c in range(n_classes)]
        rng = np.random.default_rng(seed)
        self.records = []
        self._meta = {}
        for c in range(n_classes):
            for j in range(clips_per_class):
                vid = f"{name}_c{c:03d}_v{j:03d}"
                f = int(rng.integers(min_frames, max_frames + 1))
                self.records.append(VideoRecord(vid, f, c))
                self._meta[vid] = (c, j)

    def get_frames(self, record: VideoRecord,
                   indices: np.ndarray) -> np.ndarray:
        c, j = self._meta[record.video_id]
        render = (fixtures.synthetic_virtual_clip if self._virtual
                  else fixtures.synthetic_clip)
        clip = render(c, j, record.num_frames, self.height, self.width)
        return clip[np.asarray(indices)]


class VideoFileDataset:
    """VideoDataset directly over source video files (mp4/avi/...), cv2.

    Extraction and ``tools/pack_eovc`` read the source videos directly, with
    no offline pass to frame folders; cv2's bundled ffmpeg decodes.

    Layout: ``root/<class_name>/<video>.<ext>`` with classes = sorted
    subdirectory names, or an explicit split list of
    ``(relative_path, num_frames, label)`` (num_frames <= 0 probes the
    container). Frame indexing is sequential-``grab`` based — exact and
    container-independent, where ``CAP_PROP_POS_FRAMES`` seeking is
    codec-dependent — so reading K spread TSN indices costs about one
    decode of the clip up to the last index. That is the honest cost of
    working from videos; this dataset is the onramp, production throughput
    packs to EOVC once (`pack_eovc --dataset videodir`) and feeds the
    native loader.
    """

    EXTS = (".mp4", ".avi", ".mkv", ".mov", ".webm")

    def __init__(
        self,
        root: str,
        split: Sequence[tuple[str, int, int]] | None = None,
        class_names: Sequence[str] | None = None,
        only_classes: Sequence[str] | None = None,
    ):
        self.root = root
        if split is None:
            classes = sorted(
                d for d in os.listdir(root)
                if os.path.isdir(os.path.join(root, d))
            )
            if only_classes is not None:
                # Restrict DISCOVERY (not just labels): construction probes
                # frame counts per file, so filtering before probing avoids
                # opening every container of the classes a --class-split
                # run is about to drop anyway.
                keep = set(only_classes)
                found = [c for c in classes if c in keep]
                if not classes:
                    # A labeled run (--class-split) against a root with NO
                    # class directories must not fall through to the
                    # flat-root deployment branch: every file would be
                    # ingested as pseudo-class 'unknown' label 0.
                    raise FileNotFoundError(
                        f"{root} has no class subdirectories but "
                        f"{len(keep)} classes were requested (labeled "
                        "runs need <root>/<class>/<video> layout; the "
                        "flat-root form is for unlabeled classify only)"
                    )
                if not found:
                    # A split/directory name mismatch must not fall through
                    # to the flat-root deployment branch below.
                    raise FileNotFoundError(
                        f"none of the {len(keep)} requested classes match "
                        f"the {len(classes)} class directories under "
                        f"{root} (e.g. have {classes[:3]}, "
                        f"want {sorted(keep)[:3]})"
                    )
                classes = found
            if classes:
                class_names = classes
                split = [
                    (os.path.join(c, f), 0, label)
                    for label, c in enumerate(classes)
                    for f in sorted(os.listdir(os.path.join(root, c)))
                    if f.lower().endswith(self.EXTS)
                ]
            else:
                # Flat root of video files: unlabeled deployment queries
                # (`eov classify`) — one pseudo-class, label 0.
                class_names = ["unknown"]
                split = [
                    (f, 0, 0) for f in sorted(os.listdir(root))
                    if f.lower().endswith(self.EXTS)
                ]
            if not split:
                raise FileNotFoundError(f"no video files under {root}")
        if class_names is None:
            class_names = [
                str(i) for i in range(max(s[2] for s in split) + 1)
            ]
        self.class_names = list(class_names)
        self.records = [
            VideoRecord(p, n if n and n > 0 else self._probe_frames(p), l)
            for p, n, l in split
        ]

    def _open(self, rel_path: str):
        import cv2

        cap = cv2.VideoCapture(os.path.join(self.root, rel_path))
        if not cap.isOpened():
            raise IOError(f"cannot open video: {rel_path}")
        return cap

    def _probe_frames(self, rel_path: str) -> int:
        import cv2

        cap = self._open(rel_path)
        try:
            n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            if n > 0:
                return n
            # Broken container metadata: count by grabbing (slow, correct).
            n = 0
            while cap.grab():
                n += 1
            if n == 0:
                raise IOError(f"no decodable frames: {rel_path}")
            return n
        finally:
            cap.release()

    def get_frames(self, record: VideoRecord, indices: np.ndarray) -> np.ndarray:
        with trace.span("read"):
            return self._frames(record, indices)

    def _frames(self, record: VideoRecord, indices: np.ndarray) -> np.ndarray:
        idx = np.asarray(indices)
        needed = {int(i) for i in idx}
        if min(needed) < 0:
            raise IndexError(f"negative frame index for {record.video_id}")
        got: dict[int, np.ndarray] = {}
        cap = self._open(record.video_id)
        try:
            last = None
            for t in range(max(needed) + 1):
                if t in needed:
                    ok, frame = cap.read()  # grab + retrieve
                    if not ok:
                        break
                    last = frame[:, :, ::-1]  # BGR -> RGB
                    got[t] = last
                elif not cap.grab():
                    break
            if not got:
                raise IOError(f"decode produced no frames: {record.video_id}")
            if len(got) < len(needed):
                # Container metadata overcounted num_frames: TSN-pad the
                # tail with the last decodable frame (deterministic; the
                # reference's frame loaders pad short videos the same way).
                log.warning(
                    "%s: only %d of %d requested frames decodable; "
                    "padding tail with the last frame",
                    record.video_id, len(got), len(needed),
                )
                for t in needed:
                    if t not in got:
                        got[t] = last
        finally:
            cap.release()
        return np.stack([got[int(i)] for i in idx])

    def get_batch(
        self, records, indices: np.ndarray, out: np.ndarray | None = None
    ) -> np.ndarray:
        """Pooled threaded decode [B, K, H, W, 3].

        cv2's decode releases the GIL, so worker threads parallelize the
        per-record sequential-grab reads across host cores — each record
        is its own file, so every ``get_frames`` call opens (and releases)
        its own ``VideoCapture`` (``EOV_VIDEODIR_THREADS`` overrides the
        pool size; default = os.cpu_count). Decodes are per-record independent, so
        the result is exactly ``stack([get_frames(r, i) ...])`` — the
        parity test is tests/test_video_files.py. Mixed-resolution roots
        raise (the caller's per-record fallback handles those); with
        ``out=`` workers write their rows straight into the caller's ring
        buffer.
        """
        with trace.span("read"):
            return self._batch(records, indices, out)

    def _batch(self, records, indices: np.ndarray,
               out: np.ndarray | None) -> np.ndarray:
        import concurrent.futures as cf

        indices = np.asarray(indices)
        b, k = len(records), indices.shape[1]
        workers = int(os.environ.get("EOV_VIDEODIR_THREADS", 0)) or (
            os.cpu_count() or 1
        )
        workers = max(1, min(workers, b))

        rows: list[np.ndarray | None] = [None] * b

        def _one(pos: int) -> None:
            frames = self._frames(records[pos], indices[pos])
            if out is not None:
                if frames.shape != out.shape[1:]:
                    raise ValueError(
                        f"out buffer mismatch: {records[pos].video_id} "
                        f"decodes to {frames.shape}, out rows are "
                        f"{out.shape[1:]}"
                    )
                out[pos] = frames
            else:
                rows[pos] = frames

        if workers == 1:
            for pos in range(b):
                _one(pos)
        else:
            with cf.ThreadPoolExecutor(max_workers=workers) as pool:
                for f in [pool.submit(_one, p) for p in range(b)]:
                    f.result()  # re-raise worker errors in submit order
        if out is not None:
            return out
        shapes = {r.shape for r in rows}  # type: ignore[union-attr]
        if len(shapes) > 1:
            raise ValueError(
                f"mixed frame resolutions in pooled videodir batch: "
                f"{sorted(shapes)} — resolution-normalize or use the "
                "per-record path"
            )
        return np.stack(rows)  # type: ignore[arg-type]


class FrameFolderDataset:
    """TSN-convention frame folders: ``root/<video>/{tmpl % i}`` JPEG frames.

    Frame index template follows the reference convention of 1-based
    ``img_{:05d}.jpg`` files; decode via PIL (always present) with OpenCV as
    the alternative backend.
    """

    def __init__(
        self,
        root: str,
        split: Sequence[tuple[str, int, int]],
        class_names: Sequence[str],
        image_tmpl: str = "img_{:05d}.jpg",
        backend: str = "pil",
    ):
        self.root = root
        self.image_tmpl = image_tmpl
        self.backend = backend
        self.class_names = list(class_names)
        self.records = [VideoRecord(p, n, l) for p, n, l in split]

    def _decode(self, path: str) -> np.ndarray:
        if self.backend == "cv2":
            import cv2

            img = cv2.imread(path, cv2.IMREAD_COLOR)
            if img is None:
                raise IOError(f"decode failed: {path}")
            return img[:, :, ::-1]  # BGR -> RGB
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))

    def get_frames(self, record: VideoRecord, indices: np.ndarray) -> np.ndarray:
        with trace.span("read"):
            frames = [
                self._decode(
                    os.path.join(
                        self.root, record.video_id,
                        self.image_tmpl.format(int(i) + 1)
                    )
                )
                for i in np.asarray(indices)
            ]
            return np.stack(frames)


class EovcVideoDataset:
    """VideoDataset over EOVC shards (runtime/eovc.py format).

    ``path`` may be a single ``.eovc`` file or a directory of them (a
    sharded dataset, as ``tools/pack_eovc --clips-per-shard`` writes; shard
    boundaries are invisible to callers). Reads with the native threaded
    loader (runtime/native.py) where it is built, else with the python
    reader; ``is_native`` says which. Class names come from the
    ``classes.json`` sidecar or default to label indices.
    """

    def __init__(self, path: str, class_names: Sequence[str] | None = None,
                 prefer_native: bool = True, jpeg_scale_denom: int = 1):
        if os.path.isdir(path):
            paths = sorted(glob.glob(os.path.join(path, "*.eovc")))
            if not paths:
                raise FileNotFoundError(f"no .eovc shards under {path}")
        else:
            paths = [path]

        self._loaders = []  # (native: bool, loader) per shard
        for p in paths:
            native = None
            if prefer_native:
                try:
                    from eov_tpu_torch.runtime.native import (
                        NativeClipLoader, native_available,
                    )

                    if native_available():
                        native = NativeClipLoader(
                            p, scale_denom=jpeg_scale_denom
                        )
                except (OSError, RuntimeError):
                    if jpeg_scale_denom != 1:
                        raise  # an explicit scale request must not
                        # silently fall back to full-resolution decode
                    native = None
            if native is not None:
                self._loaders.append((True, native))
            else:
                if jpeg_scale_denom != 1:
                    from eov_tpu_torch.runtime.native import build_error

                    why = build_error() if prefer_native else (
                        "prefer_native=False")
                    raise ValueError(
                        "jpeg_scale_denom is a native-loader feature "
                        "(DCT-domain scaling in native/clip_loader.cc), "
                        f"and the native loader is not in use: {why}"
                    )
                from eov_tpu_torch.runtime.eovc import EovcReader

                self._loaders.append((False, EovcReader(p)))

        self.records = []
        self._index = {}  # video_id -> (shard, local clip idx)
        for s, (is_nat, ld) in enumerate(self._loaders):
            if is_nat:
                infos = [ld.clip_info(i) for i in range(ld.n_clips)]
            else:
                infos = [(c.video_id, c.label, c.n_frames) for c in ld.clips]
            for i, (vid, label, nf) in enumerate(infos):
                if vid in self._index:
                    raise ValueError(f"duplicate video_id across shards: {vid}")
                self.records.append(VideoRecord(vid, nf, label))
                self._index[vid] = (s, i)
        if not class_names:
            # pack_eovc writes a class-name sidecar next to the shards (the
            # container stores integer labels only); auto-loading it keeps
            # real names through the pack -> extract chain, which embodied
            # fusion needs (virtual banks align by class NAME).
            sidecar = (
                os.path.join(path, "classes.json") if os.path.isdir(path)
                else path + ".classes.json"
            )
            if os.path.exists(sidecar):
                with open(sidecar) as f:
                    class_names = json.load(f)["class_names"]
        max_label = max((r.label for r in self.records), default=-1)
        if class_names and len(class_names) <= max_label:
            raise ValueError(
                f"class names list ({len(class_names)}) shorter than the "
                f"stored label range (max label {max_label}) — wrong or "
                "stale sidecar/split for these shards?"
            )
        self.class_names = (
            list(class_names)
            if class_names
            else [str(i) for i in range(max_label + 1)]
        )

    @property
    def is_native(self) -> bool:
        return all(is_nat for is_nat, _ in self._loaders)

    def _load_one(self, shard: int, clip: int, idx: np.ndarray) -> np.ndarray:
        is_nat, ld = self._loaders[shard]
        if is_nat:
            return ld.load_batch([clip], idx[None, :])[0]
        return ld.load_frames(clip, idx)

    def get_frames(self, record: VideoRecord, indices: np.ndarray) -> np.ndarray:
        with trace.span("read"):
            s, i = self._index[record.video_id]
            clip = self._load_one(s, i, np.asarray(indices, np.int32))
            trace.count("eovc.bytes", clip.nbytes)
            trace.count("eovc.clips")
            return clip

    def _frame_hw(self) -> tuple[int, int]:
        is_nat, ld = self._loaders[0]
        return (ld.height, ld.width) if is_nat else (ld.h, ld.w)

    def get_batch(
        self, records, indices: np.ndarray, out: np.ndarray | None = None
    ) -> np.ndarray:
        """Pooled multi-clip load [B, K, H, W, 3] (native fast path).

        Groups records by shard so each shard's thread pool decodes its
        members in one call; order is restored to match ``records``.
        ``out`` reuses a caller buffer: fresh buffers of more than 32 MB are
        unmapped on free (glibc), so without it every batch pays first-touch
        page faults; extract.py rotates a small ring of them, page-locked
        when the batch goes to the GPU.
        Per-shard runs that are contiguous in ``records`` decode straight
        into the output with zero extra copies.
        """
        with trace.span("read"):
            out = self._batch(records, indices, out)
            trace.count("eovc.bytes", out.nbytes)
            trace.count("eovc.clips", len(records))
            return out

    def _batch(self, records, indices: np.ndarray,
               out: np.ndarray | None) -> np.ndarray:
        indices = np.asarray(indices, np.int32)
        b, k = len(records), indices.shape[1]
        h, w = self._frame_hw()
        shape = (b, k, h, w, 3)
        if out is None:
            out = np.empty(shape, np.uint8)
        elif out.shape != shape or out.dtype != np.uint8:
            raise ValueError(
                f"out buffer mismatch: want u8 {shape}, got "
                f"{out.dtype} {out.shape}"
            )
        by_shard: dict[int, list[int]] = {}
        locs = []
        for pos, r in enumerate(records):
            s, i = self._index[r.video_id]
            by_shard.setdefault(s, []).append(pos)
            locs.append((s, i))
        for s, positions in by_shard.items():
            is_nat, ld = self._loaders[s]
            ids = [locs[p][1] for p in positions]
            idx = indices[positions]
            p0, p1 = positions[0], positions[-1] + 1
            contiguous = positions == list(range(p0, p1))
            if is_nat:
                if contiguous:
                    ld.load_batch(ids, idx, out=out[p0:p1])
                else:
                    out[positions] = ld.load_batch(ids, idx)
            else:
                dst = out[p0:p1] if contiguous else None
                for j, (i, f) in enumerate(zip(ids, idx)):
                    frames = ld.load_frames(i, f)
                    if dst is not None:
                        dst[j] = frames
                    else:
                        out[positions[j]] = frames
        return out


def load_split_txt(path: str) -> list[tuple[str, int, int]]:
    """TSN split list: ``<video_path> <num_frames> <label>`` per line."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            p, n, l = line.rsplit(maxsplit=2)
            out.append((p, int(n), int(l)))
    return out


def save_split_txt(path: str, split: Sequence[tuple[str, int, int]]) -> None:
    with open(path, "w") as f:
        for p, n, l in split:
            f.write(f"{p} {n} {l}\n")


def load_split_json(path: str) -> dict:
    """eov_tpu-native split format: class names + per-split video lists.

    {"class_names": [...],
     "splits": {"train": [[video_id, num_frames, label], ...], ...}}
    """
    with open(path) as f:
        return json.load(f)


def save_split_json(path: str, class_names, splits) -> None:
    with open(path, "w") as f:
        json.dump({"class_names": list(class_names), "splits": splits}, f)
