"""What the port's benches share: the device, the card line, the peak
table, the timing window and the trace switch.

* ``bench_device()`` — ``EOV_BENCH_DEVICE`` (default ``cuda``; the CPU
  tests set ``cpu``). A CUDA request on a machine without a GPU raises: a
  bench never falls back to the CPU.
* ``card()`` — the card's name and power limit as ``nvidia-smi
  --query-gpu=name,power.limit`` reads them (None on the CPU).
* ``mfu_fields`` — achieved FLOP/s over the card's dense peak from
  ``PEAKS``, keyed on ``torch.cuda.get_device_name``; an unknown card or
  the CPU gets ``mfu: null`` and a ``peak_source`` saying why.
* ``step_seconds`` — one timing window: ``window`` back-to-back calls
  between two CUDA events and one synchronize (the host clock on the
  CPU), per call.
* ``traced`` — ``utils/trace.py`` around the timed windows when the
  bench's trace variable names a directory.
* ``frame_source`` / ``clip_dataset`` — the deployment benches' query
  clips (classify, episode): the synthetic clips written as JPEG frame
  folders read through PIL (``jpeg``, the reference's fixture), or packed
  into one RAW EOVC shard by ``tools/pack_eovc`` and read by the port's
  EOVC reader (``eovc_raw``, for a machine without PIL).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time

import torch

from eov_tpu_torch.utils.device import resolve_device

__all__ = ["PEAKS", "FRAME_SOURCES", "bench_device", "env_default", "card",
           "mfu_fields", "build_kernels", "sync", "step_seconds", "traced",
           "emit",
           "frame_source", "clip_dataset", "reader_name"]

# Dense (no sparsity) tensor-core peaks: card name -> (bf16 TFLOP/s, int8
# TOP/s, source). NVIDIA's H100 data sheet gives the sparse rates; dense is
# half of each.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (
        989.4, 1978.9,
        "NVIDIA H100 Tensor Core GPU data sheet, H100 SXM5: 1,979 TFLOP/s "
        "bf16 and 3,958 TOP/s int8 with sparsity, half of each dense"),
    "NVIDIA H100 PCIe": (
        756.5, 1513.0,
        "NVIDIA H100 Tensor Core GPU data sheet, H100 PCIe: 1,513 TFLOP/s "
        "bf16 and 3,026 TOP/s int8 with sparsity, half of each dense"),
}


def bench_device() -> torch.device:
    return resolve_device(os.environ.get("EOV_BENCH_DEVICE", "cuda"))


def env_default(name: str, on_cuda: str, elsewhere: str,
                dev: torch.device) -> str:
    """``$name``, else the default for the bench's device."""
    return os.environ.get(name, on_cuda if dev.type == "cuda" else elsewhere)


def card(dev: torch.device) -> dict | None:
    if dev.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(dev.index or 0)],
        capture_output=True, text=True, timeout=60, check=True)
    name, _, limit = out.stdout.strip().splitlines()[0].partition(", ")
    return {"name": name, "power_limit": limit}


def mfu_fields(flops_per_s: float, dev: torch.device,
               int8: bool = False) -> dict:
    """``{mfu, peak_tflops, peak_source}``: achieved over the dense bf16
    peak (the int8 peak when ``int8``)."""
    if dev.type != "cuda":
        return {"mfu": None, "peak_tflops": None,
                "peak_source": f"{dev.type}: no device peak"}
    name = torch.cuda.get_device_name(dev)
    row = PEAKS.get(name)
    if row is None:
        return {"mfu": None, "peak_tflops": None,
                "peak_source": f"no peak for {name!r} in bench/common.py "
                               "PEAKS"}
    peak = row[1] if int8 else row[0]
    return {"mfu": round(flops_per_s / (peak * 1e12), 4),
            "peak_tflops": peak,
            "peak_source": f"{'int8' if int8 else 'bf16'}: {row[2]}"}


def build_kernels(dev: torch.device) -> float | None:
    """Seconds to build the port's CUDA kernels (nvcc, untimed by the
    windows); None on the CPU."""
    if dev.type != "cuda":
        return None
    from eov_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.build_all()
    return round(time.perf_counter() - t0, 3)


def sync(dev: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def step_seconds(fn, window: int, dev: torch.device) -> float:
    """Seconds per call over ``window`` back-to-back calls of ``fn``."""
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(window):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3 / window
    t0 = time.perf_counter()
    for _ in range(window):
        fn()
    return (time.perf_counter() - t0) / window


def traced(env_name: str, dev: torch.device):
    """A ``--trace`` capture into ``$env_name`` if it is set, else a no-op
    context."""
    trace_dir = os.environ.get(env_name)
    if not trace_dir:
        return contextlib.nullcontext()
    from eov_tpu_torch.utils.trace import trace

    return trace(trace_dir, dev)


def emit(record: dict) -> None:
    """The bench's one JSON line on stdout."""
    print(json.dumps(record), flush=True)


FRAME_SOURCES = ("jpeg", "eovc_raw")


def frame_source(env_name: str) -> str:
    """``$env_name`` (default ``jpeg``), checked: nothing switches on its
    own."""
    src = os.environ.get(env_name, "jpeg")
    if src not in FRAME_SOURCES:
        raise SystemExit(f"{env_name}={src!r}: expected one of "
                         f"{FRAME_SOURCES}")
    return src


def clip_dataset(root: str, syn, source: str):
    """The clips of the synthetic dataset ``syn`` stored under ``root`` as
    ``source`` says, read back as a dataset with the same records."""
    import numpy as np

    from eov_tpu_torch.data import datasets

    if source == "eovc_raw":
        from eov_tpu_torch.tools.pack_eovc import pack

        path = os.path.join(root, "clips.eovc")
        pack(syn, path, storage_short_side=None, codec="raw")
        return datasets.EovcVideoDataset(path)
    from PIL import Image  # lazily: a machine without PIL uses eovc_raw

    split = []
    for rec in syn.records:
        clip = syn.get_frames(rec, np.arange(rec.num_frames))
        vdir = os.path.join(root, rec.video_id)
        os.makedirs(vdir, exist_ok=True)
        for t, frame in enumerate(clip):
            Image.fromarray(np.ascontiguousarray(frame)).save(
                os.path.join(vdir, f"img_{t + 1:05d}.jpg"), quality=90)
        split.append((rec.video_id, rec.num_frames, rec.label))
    return datasets.FrameFolderDataset(root, split, syn.class_names)


def reader_name(ds) -> str:
    """Which reader a ``clip_dataset`` reads through."""
    if not hasattr(ds, "is_native"):
        return type(ds).__name__
    return f"{type(ds).__name__} ({'native' if ds.is_native else 'python'})"
