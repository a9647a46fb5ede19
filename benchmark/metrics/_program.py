"""Shares read from the program's own spans and counters: the reports that
``eov_tpu_torch.utils.trace`` keeps of each epoch (``train.epoch``) or
pass (``extract.pass``) in this process, rank 0's on several chips.

A reader takes the reports of its kind that ended after the last one a
profiler was active in: in a traced run those are the whole epochs or
passes of the window's untraced tail (the profiler stops at a lap), and
set-up's warm-up epoch or pass is left out. Without such a report, or
with a program that keeps none, it returns nothing.

The device gaps are the program's CUDA-event account of the time its
compute stream sat idle while the host did host-only work; they are a
lower bound on idle (idle inside a span that launches device work is not
counted, nor the NCCL stream's).
"""

from __future__ import annotations


def tail(kind: str) -> list[dict]:
    """The reports of ``kind`` ('train' or 'extract') after the last
    profiled one; [] without one."""
    try:
        from eov_tpu_torch.utils import trace

        reports = trace.reports()
    except (ImportError, AttributeError):
        return []
    mine = [r for r in reports if r.get("kind") == kind]
    last = max((i for i, r in enumerate(mine) if r.get("profiled")),
               default=None)
    return [] if last is None else mine[last + 1:]


def gap_share(kind: str, spans=None) -> float | None:
    """The device gaps over the tail's wall time, in percent: all of them,
    or the part put down to ``spans`` (self time of the root included
    where its name is listed)."""
    reps = tail(kind)
    if not reps or any(r.get("device_gap_s") is None for r in reps):
        return None
    wall = sum(r["wall_s"] for r in reps)
    if wall <= 0:
        return None
    if spans is None:
        gap = sum(r["device_gap_s"] for r in reps)
    else:
        gap = sum(r["device_gap_by_span"].get(s, 0.0) for r in reps
                  for s in spans)
    return 100.0 * gap / wall
