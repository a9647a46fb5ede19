"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. A CUDA
request on a machine without a usable GPU raises; nothing falls back to the
CPU on its own.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: torch.device | str | None = "cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' (CLI: --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
