"""TSN segment sampling on the host (counterpart of
``eov_tpu/data/segments.py:center_indices_np``)."""

from __future__ import annotations

import numpy as np

__all__ = ["center_indices_np"]


def center_indices_np(num_frames: int, num_segments: int) -> np.ndarray:
    """Center frame of each of K equal segments: ``(F*(2k+1)) // (2K)``,
    the exact integer form of the TSN test-time rule, clamped to [0, F)."""
    k = num_segments
    idx = (num_frames * (2 * np.arange(k) + 1)) // (2 * k)
    return np.minimum(idx, num_frames - 1)
