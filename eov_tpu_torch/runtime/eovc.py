"""EOVC container: pure-python writer and reader.

Counterpart of ``eov_tpu/runtime/eovc.py``, byte for byte the same format
(``native/eovc_format.md``): a header, the concatenated frame payloads,
then a clip index. The writer is the only one (packing is offline); the
reader serves where the native loader (``runtime/native.py``) is not
built, and is its oracle in the tests. RAW shards hold uint8 frames
already resized to the storage size, so reading is a copy; JPEG shards
decode here with PIL, imported only in that branch.
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import Sequence

import numpy as np

__all__ = ["EOVC_MAGIC", "CODEC_RAW", "CODEC_JPEG", "ClipInfo",
           "EovcWriter", "EovcReader"]

EOVC_MAGIC = 0x43564F45
CODEC_RAW = 0
CODEC_JPEG = 1

_HDR = struct.Struct("<IIQQIII")          # magic, ver, n_clips, index_off, h, w, codec
_CLIP_FIXED = struct.Struct("<64siiQ")    # video_id, label, n_frames, reserved


@dataclasses.dataclass
class ClipInfo:
    video_id: str
    label: int
    n_frames: int
    frame_off: np.ndarray  # u64 [n_frames]
    frame_len: np.ndarray  # u32 [n_frames]


class EovcWriter:
    """Stream clips into an EOVC file.

    codec='raw': frames are uint8 [F, H, W, 3] arrays, stored verbatim
    (pre-resize them to the pipeline's storage resolution first).
    codec='jpeg': frames are already-encoded JPEG byte strings at a uniform
    decoded size (h, w).
    """

    def __init__(self, path: str, h: int, w: int, codec: str = "raw"):
        self._f = open(path, "wb")
        self.h, self.w = h, w
        self.codec = CODEC_RAW if codec == "raw" else CODEC_JPEG
        self._clips: list[ClipInfo] = []
        # Header placeholder; rewritten on close.
        self._f.write(_HDR.pack(EOVC_MAGIC, 1, 0, 0, h, w, self.codec))

    def add_clip(self, video_id: str, label: int, frames) -> None:
        offs, lens = [], []
        if self.codec == CODEC_RAW:
            arr = np.ascontiguousarray(frames, np.uint8)
            if arr.shape[1:] != (self.h, self.w, 3):
                raise ValueError(f"frame shape {arr.shape[1:]} != ({self.h},{self.w},3)")
            for t in range(arr.shape[0]):
                offs.append(self._f.tell())
                payload = arr[t].tobytes()
                lens.append(len(payload))
                self._f.write(payload)
        else:
            for payload in frames:  # iterable of bytes
                offs.append(self._f.tell())
                lens.append(len(payload))
                self._f.write(payload)
        self._clips.append(
            ClipInfo(video_id, label, len(offs),
                     np.asarray(offs, np.uint64), np.asarray(lens, np.uint32))
        )

    def close(self) -> None:
        index_off = self._f.tell()
        for c in self._clips:
            vid = c.video_id.encode()[:63]
            self._f.write(_CLIP_FIXED.pack(vid, c.label, c.n_frames, 0))
            self._f.write(c.frame_off.astype("<u8").tobytes())
            self._f.write(c.frame_len.astype("<u4").tobytes())
        self._f.seek(0)
        self._f.write(
            _HDR.pack(EOVC_MAGIC, 1, len(self._clips), index_off,
                      self.h, self.w, self.codec)
        )
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class EovcReader:
    """Pure-python reader (where the native loader is not built)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            data = f.read()
        self._data = data
        (magic, ver, n_clips, index_off, self.h, self.w, self.codec) = _HDR.unpack_from(data, 0)
        if magic != EOVC_MAGIC or ver != 1:
            raise ValueError(f"not an EOVC v1 file: {path}")
        # Same dimension-sanity bound as the native loader (clip_loader.cc):
        # readers size output buffers from h/w, so a corrupt header must
        # fail open rather than become an allocation bomb at read time.
        if self.h <= 0 or self.w <= 0 or self.h * self.w > (1 << 26):
            raise ValueError(
                f"EOVC header has implausible frame dims {self.h}x{self.w}"
            )
        if n_clips > max(0, len(data) - index_off) // _CLIP_FIXED.size:
            raise ValueError("EOVC index is larger than the file")
        self.clips: list[ClipInfo] = []
        off = index_off
        for _ in range(n_clips):
            vid, label, n_frames, _r = _CLIP_FIXED.unpack_from(data, off)
            off += _CLIP_FIXED.size
            fo = np.frombuffer(data, "<u8", n_frames, off)
            off += 8 * n_frames
            fl = np.frombuffer(data, "<u4", n_frames, off)
            off += 4 * n_frames
            self.clips.append(
                ClipInfo(vid.rstrip(b"\0").decode(), label, n_frames, fo, fl)
            )

    def load_frames(self, clip_idx: int, frame_indices: Sequence[int]) -> np.ndarray:
        c = self.clips[clip_idx]
        out = np.empty((len(frame_indices), self.h, self.w, 3), np.uint8)
        for i, f in enumerate(frame_indices):
            start, ln = int(c.frame_off[f]), int(c.frame_len[f])
            payload = self._data[start : start + ln]
            if self.codec == CODEC_RAW:
                out[i] = np.frombuffer(payload, np.uint8).reshape(
                    self.h, self.w, 3
                )
            else:
                from PIL import Image

                out[i] = np.asarray(
                    Image.open(io.BytesIO(payload)).convert("RGB")
                )
        return out
