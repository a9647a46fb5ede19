"""``--trace DIR``: a ``torch.profiler`` trace of a command or a bench.

Counterpart of the reference's ``jax.profiler`` capture (``eov_tpu/cli.py
--trace``, ``EOV_BENCH_TRACE``, ``EOV_TRAIN_TRACE``). ``trace(dir,
device)`` profiles the block with the CPU activity, plus CUDA when the
device is ``cuda``, and writes under ``dir``:

* ``<host>_<pid>.<ms>.pt.trace.json`` — the Chrome trace
  (``chrome://tracing``, Perfetto);
* ``trace_meta.json`` — ``{"device", "device_name", "trace",
  "activities"}``: which device the trace is of and which file holds it.

``tools/profile_summary.py DIR`` reads both. A CUDA request without a GPU
raises before anything is profiled.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time

import torch

from eov_tpu_torch.utils.device import resolve_device

__all__ = ["trace", "META"]

META = "trace_meta.json"


@contextlib.contextmanager
def trace(trace_dir: str, device: torch.device | str = "cuda"):
    """Profile the block; write the trace and its meta file on exit."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize(dev)
    name = (f"{socket.gethostname()}_{os.getpid()}."
            f"{int(time.time() * 1000)}.pt.trace.json")
    prof.export_chrome_trace(os.path.join(trace_dir, name))
    meta = {"device": dev.type,
            "device_name": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
            "trace": name,
            "activities": [a.name for a in activities]}
    with open(os.path.join(trace_dir, META), "w") as f:
        json.dump(meta, f)
