"""RAW EOVC shards: the writer that packs the benchmark's clips and the
reader the reference reads them back with.

Copied from ``eov_tpu_torch/runtime/eovc.py`` at commit 1d21111
(``EOVC_MAGIC``, the header and clip-index structs, ``EovcWriter`` in its
RAW codec, ``EovcReader.load_frames`` in its RAW codec). The layout: a
header, the concatenated uint8 frame payloads, then a clip index (id,
label, frame count, per-frame offset and length).
"""

from __future__ import annotations

import struct

import numpy as np

EOVC_MAGIC = 0x43564F45
CODEC_RAW = 0
_HDR = struct.Struct("<IIQQIII")        # magic, ver, n_clips, index_off, h, w, codec
_CLIP_FIXED = struct.Struct("<64siiQ")  # video_id, label, n_frames, reserved


class RawWriter:
    """Stream uint8 clips [F, H, W, 3] into one RAW EOVC file."""

    def __init__(self, path: str, h: int, w: int):
        self._f = open(path, "wb")
        self.h, self.w = h, w
        self._clips: list[tuple] = []
        self._f.write(_HDR.pack(EOVC_MAGIC, 1, 0, 0, h, w, CODEC_RAW))

    def add_clip(self, video_id: str, label: int, frames: np.ndarray) -> None:
        arr = np.ascontiguousarray(frames, np.uint8)
        if arr.shape[1:] != (self.h, self.w, 3):
            raise ValueError(f"frame shape {arr.shape[1:]} != "
                             f"({self.h}, {self.w}, 3)")
        start = self._f.tell()
        size = self.h * self.w * 3
        self._f.write(arr.tobytes())
        offs = start + size * np.arange(arr.shape[0], dtype=np.uint64)
        lens = np.full(arr.shape[0], size, np.uint32)
        self._clips.append((video_id, label, arr.shape[0], offs, lens))

    def close(self) -> None:
        index_off = self._f.tell()
        for vid, label, n, offs, lens in self._clips:
            self._f.write(_CLIP_FIXED.pack(vid.encode()[:63], label, n, 0))
            self._f.write(offs.astype("<u8").tobytes())
            self._f.write(lens.astype("<u4").tobytes())
        self._f.seek(0)
        self._f.write(_HDR.pack(EOVC_MAGIC, 1, len(self._clips), index_off,
                                self.h, self.w, CODEC_RAW))
        self._f.close()


class RawReader:
    """Clip index and frames of one RAW EOVC file (memory-mapped)."""

    def __init__(self, path: str):
        self._data = np.memmap(path, np.uint8, mode="r")
        buf = self._data
        magic, ver, n_clips, off, self.h, self.w, codec = _HDR.unpack_from(
            buf, 0)
        if magic != EOVC_MAGIC or ver != 1 or codec != CODEC_RAW:
            raise ValueError(f"not a RAW EOVC v1 file: {path}")
        self.clips = []  # (video_id, label, n_frames, offsets)
        for _ in range(n_clips):
            vid, label, n, _r = _CLIP_FIXED.unpack_from(buf, off)
            off += _CLIP_FIXED.size
            offs = np.frombuffer(buf, "<u8", n, off)
            off += 12 * n
            self.clips.append((vid.rstrip(b"\0").decode(), label, n, offs))

    def load_frames(self, clip: int, frames) -> np.ndarray:
        offs = self.clips[clip][3]
        size = self.h * self.w * 3
        return np.stack([np.asarray(self._data[int(offs[f]):int(offs[f])
                                               + size]).reshape(
            self.h, self.w, 3) for f in frames])
