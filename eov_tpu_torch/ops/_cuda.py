"""Build and load the port's hand-written CUDA kernels (nvcc + ctypes).

Each kernel source in ``eov_tpu_torch/csrc/`` exposes a plain C launcher
that enqueues the kernel on the stream it is given and returns
``cudaGetLastError()``. It is compiled with nvcc for Hopper
(``sm_90a``) into ``build/torch_kernels/`` at the repository root, on first
use, and loaded with ``ctypes``. The library name carries a hash of the
source and of the shared headers (``csrc/*.cuh``), so an edited kernel is
never served from a stale build. No PyTorch headers are involved, so a
build takes seconds.

Nothing here runs at import time: the CPU tests import every module of the
port on machines without nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from eov_tpu_torch.utils import trace

__all__ = ["SOURCES", "build", "build_all", "load", "check", "stream_ptr",
           "ptr"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("crop_normalize", "bottleneck_stack", "episode_scores",
           "bottleneck_train", "bottleneck_int8", "maxpool_s2", "basic_stack",
           "temporal_shift")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "eov_tpu_torch are built from source on the machine with the GPU"
    )


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names=SOURCES) -> dict[str, float]:
    """Compile the named kernels that are not yet built, one nvcc each, all
    started together. Returns {name: seconds} for the ones compiled; the
    trace counter ``cuda.build_s`` adds each one's seconds."""
    _nvcc()  # refuse before touching the build directory
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ), tmp, out, time.perf_counter())
    took, errors = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        trace.count("cuda.build_s", took[name])
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def build_all() -> dict[str, float]:
    return build(SOURCES)


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build((name,))
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def check(code: int, name: str) -> None:
    """Raise if a launcher returned a non-zero ``cudaError_t``."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
