"""ctypes binding to the native EOVC clip loader.

Counterpart of ``eov_tpu/runtime/native.py``. The loader is
``eov_tpu_torch/native/clip_loader.cc`` (a copy of ``native/clip_loader.cc``,
byte for byte, so the reference's sanitizer harnesses cover it too): mmap'd
shards, libjpeg decode on a thread pool, a submit/wait queue. It is compiled
with ``g++ ... -ljpeg -lpthread`` into ``build/native/`` at the repository
root on first use, the library named by a hash of the source. Where that
build fails (no compiler, no ``jpeglib.h``), ``native_available()`` is
False, ``build_error()`` says why, and ``EovcVideoDataset`` reads with the
python reader (``runtime/eovc.py``). ``EOV_NATIVE_LIB`` names another build
of the same source to load instead (the sanitizer builds).

ctypes calls release the GIL for the whole read and decode, so a decode
thread overlaps it with the device's work on the previous batch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

__all__ = ["native_available", "build_error", "NativeClipLoader",
           "build_native"]

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "native" / "clip_loader.cc"
BUILD_DIR = _PKG.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-pthread",
             "-shared")
LIBS = ("-ljpeg", "-lpthread")

_lib = None
_build_error: str | None = None
_lock = threading.Lock()


def _lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libeovc_{digest.hexdigest()[:12]}.so"


def build_native() -> str | None:
    """Compile the loader unless built; its path, or None with the reason
    kept for ``build_error()``."""
    global _build_error
    out = _lib_path()
    if out.exists():
        return str(out)
    cxx = shutil.which("g++")
    if cxx is None:
        _build_error = "no C++ compiler (g++) on PATH"
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp),
                           *LIBS], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        _build_error = (proc.stderr or proc.stdout).strip() or (
            f"{cxx} exited {proc.returncode}")
        return None
    os.replace(tmp, out)
    return str(out)


def build_error() -> str | None:
    """Why the native loader is unavailable (None if it loaded)."""
    _load()
    return _build_error


def _declare(lib) -> None:
    lib.eovc_open.restype = ctypes.c_void_p
    lib.eovc_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.eovc_open_scaled.restype = ctypes.c_void_p
    lib.eovc_open_scaled.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int32]
    lib.eovc_close.argtypes = [ctypes.c_void_p]
    lib.eovc_n_clips.restype = ctypes.c_int64
    lib.eovc_n_clips.argtypes = [ctypes.c_void_p]
    for f in ("eovc_height", "eovc_width", "eovc_codec"):
        getattr(lib, f).restype = ctypes.c_int32
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    lib.eovc_clip_info.restype = ctypes.c_int32
    lib.eovc_clip_info.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.eovc_load_batch.restype = ctypes.c_int32
    lib.eovc_load_batch.argtypes = [
        ctypes.c_void_p, i32p, ctypes.c_int32, i32p, ctypes.c_int32, u8p,
    ]
    lib.eovc_submit.restype = ctypes.c_int32
    lib.eovc_submit.argtypes = lib.eovc_load_batch.argtypes
    lib.eovc_wait.restype = ctypes.c_int32
    lib.eovc_wait.argtypes = [ctypes.c_void_p]


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        path = os.environ.get("EOV_NATIVE_LIB") or build_native()
        if path is None:
            return None
        if not os.path.exists(path):
            _build_error = f"EOV_NATIVE_LIB={path} does not exist"
            return None
        lib = ctypes.CDLL(path)
        _declare(lib)
        _lib, _build_error = lib, None
        return lib


def native_available() -> bool:
    return _load() is not None


def _index_arrays(clip_indices, frame_indices) -> tuple:
    clips = np.ascontiguousarray(clip_indices, np.int32)
    frames = np.ascontiguousarray(frame_indices, np.int32)
    if frames.ndim != 2 or len(clips) != frames.shape[0]:
        raise ValueError(f"{len(clips)} clips but frame indices of shape "
                         f"{frames.shape}; want [clips, K]")
    return clips, frames


class NativeClipLoader:
    """Threaded mmap + decode loader over one EOVC file.

    ``load_batch``: synchronous pooled decode. ``submit``/``wait``: an async
    FIFO; submit batch i+1 before waiting on i to overlap decode with the
    device's work.
    """

    def __init__(self, path: str, n_threads: int | None = None,
                 scale_denom: int = 1):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        self._lib = lib
        if n_threads is None:
            n_threads = max(1, os.cpu_count() or 1)
        if scale_denom == 1:
            self._h = lib.eovc_open(path.encode(), n_threads)
        else:
            # DCT-domain scaled jpeg decode: frames come back at
            # 1/scale_denom of the storage size, and height/width below
            # report the scaled size so callers size their buffers right.
            self._h = lib.eovc_open_scaled(path.encode(), n_threads,
                                           int(scale_denom))
        if not self._h:
            raise IOError(
                f"eovc_open failed: {path}"
                + (f" (scale_denom={scale_denom}: jpeg-codec shards only, "
                   "denom in 1/2/4/8)" if scale_denom != 1 else ""))
        self.n_clips = int(lib.eovc_n_clips(self._h))
        self.height = int(lib.eovc_height(self._h))
        self.width = int(lib.eovc_width(self._h))
        self.codec = int(lib.eovc_codec(self._h))
        # Submitted buffers stay referenced until their wait() returns.
        self._inflight: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    def clip_info(self, idx: int) -> tuple[str, int, int]:
        vid = ctypes.create_string_buffer(64)
        label = ctypes.c_int32()
        nf = ctypes.c_int32()
        rc = self._lib.eovc_clip_info(self._h, idx, vid, ctypes.byref(label),
                                      ctypes.byref(nf))
        if rc != 0:
            raise IndexError(idx)
        return vid.value.decode(), int(label.value), int(nf.value)

    def load_batch(self, clip_indices: Sequence[int],
                   frame_indices: np.ndarray,
                   out: np.ndarray | None = None) -> np.ndarray:
        """Pooled decode into ``out`` (a caller's buffer, checked) or a
        fresh array: uint8 [B, K, H, W, 3]."""
        clips, frames = _index_arrays(clip_indices, frame_indices)
        b, k = frames.shape
        shape = (b, k, self.height, self.width, 3)
        if out is None:
            out = np.empty(shape, np.uint8)
        elif (out.shape != shape or out.dtype != np.uint8
              or not out.flags.c_contiguous):
            raise ValueError(f"out buffer mismatch: want C-contiguous u8 "
                             f"{shape}, got {out.dtype} {out.shape}")
        rc = self._lib.eovc_load_batch(self._h, clips, b, frames, k, out)
        if rc != 0:
            raise IOError(f"eovc_load_batch failed: {rc}")
        return out

    def submit(self, clip_indices: Sequence[int],
               frame_indices: np.ndarray) -> np.ndarray:
        """Async decode into a fresh buffer; pair with wait() (FIFO)."""
        clips, frames = _index_arrays(clip_indices, frame_indices)
        b, k = frames.shape
        out = np.empty((b, k, self.height, self.width, 3), np.uint8)
        rc = self._lib.eovc_submit(self._h, clips, b, frames, k, out)
        if rc != 0:
            raise IOError(f"eovc_submit failed: {rc}")
        self._inflight.append((clips, frames, out))
        return out

    def wait(self) -> np.ndarray:
        """Block for the oldest submitted batch; returns its buffer."""
        rc = self._lib.eovc_wait(self._h)
        if rc == -100:
            raise RuntimeError("eovc_wait: nothing in flight")
        _, _, out = self._inflight.pop(0)
        if rc != 0:
            raise IOError(f"decode failed: {rc}")
        return out

    def close(self) -> None:
        if self._h:
            self._lib.eovc_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
