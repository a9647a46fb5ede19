"""Published peaks of the card the benchmark runs on.

The dense bf16 rates are copied from ``eov_tpu_torch/bench/common.py:PEAKS``
at commit 1d21111 (NVIDIA's H100 data sheet gives the rates with sparsity;
dense is half); the memory bandwidths from the same data sheet, as
``chip_smoke.py:HBM_BYTES_PER_S`` (commit 1d21111) holds the SXM part's.
"""

from __future__ import annotations

# card name -> (dense bf16 FLOP/s, device-memory bytes/s)
PEAKS = {
    "NVIDIA H100 80GB HBM3": (989.4e12, 3.35e12),
}


def peak(kind: str) -> tuple[float, float] | None:
    return PEAKS.get(kind)


def least_seconds(ops: float, byts: float, kind: str) -> float | None:
    """The least time the card could take: the larger of operations over
    the bf16 peak and bytes over the memory bandwidth."""
    row = PEAKS.get(kind)
    if row is None:
        return None
    return max(ops / row[0], byts / row[1])
