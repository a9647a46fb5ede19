"""The train loop's device gaps over its wall time, in percent: the
program's CUDA-event account of the compute stream's idle while the host
did host-only work, over the untraced tail's epochs (``train.epoch``
reports), rank 0's."""

from benchmark.metrics._program import gap_share


def read(run):
    return gap_share("train")
