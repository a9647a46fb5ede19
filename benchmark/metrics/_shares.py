"""Shares read from the run's spans, counts and trace, in percent."""

from __future__ import annotations

from benchmark.frozen import flops, peaks


def reader(run) -> float | None:
    """Host seconds inside the reader's spans over the untraced part of
    the window."""
    t = run.tail
    if not t or not t["read_s"] or t["seconds"] <= 0:
        return None
    return 100.0 * t["read_s"] / t["seconds"]


def idle(run) -> float | None:
    """1 - device busy (the union of kernel, memcpy and memset intervals)
    over the traced window, this rank's."""
    tr = run.prof_trace
    if tr is None or not tr.kernels or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu(run, passes: int, head: bool) -> float | None:
    """``passes`` x the analytic forward FLOPs of every image the untraced
    part of the window ran (all ranks), over its length and the chips'
    dense bf16 peak."""
    row = peaks.peak(run.kind)
    t = run.tail
    if row is None or not t or not t["images"] or t["seconds"] <= 0:
        return None
    cfg = run.cell.config
    per = flops.resnet_forward_flops(
        cfg["stage_sizes"], cfg["block"] == "bottleneck",
        (cfg["crop_size"], cfg["crop_size"]),
        num_classes=cfg["num_classes"] if head else None, width=cfg["width"])
    return 100.0 * passes * per * t["images"] / t["seconds"] / (
        run.world * row[0])
