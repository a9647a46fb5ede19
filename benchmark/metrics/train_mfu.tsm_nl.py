"""The TSM + non-local train step's share of the chip's dense bf16 peak: 3
x the forward FLOPs of the whole network (``_tsm_nl``: convs, fc, the
non-local blocks' convs and attention products) of every image the
program trained (its ``train.images``) in the untraced tail's epochs, over
their wall time and the peak, in percent."""

from benchmark.frozen import peaks
from benchmark.metrics._program import tail
from benchmark.metrics._tsm_nl import forward_flops_per_clip


def read(run):
    row = peaks.peak(run.kind)
    reps = tail("train")
    images = sum(r["counters"].get("train.images", 0) for r in reps)
    wall = sum(r["wall_s"] for r in reps)
    if row is None or not images or wall <= 0:
        return None
    cfg = run.cell.config
    per_image = forward_flops_per_clip(cfg) / cfg["train_segments"]
    return 100.0 * 3 * per_image * images / wall / (run.world * row[0])
