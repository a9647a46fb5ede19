"""The extraction loop's device gaps over its wall time, in percent: the
program's CUDA-event account of the compute stream's idle while the main
thread did host-only work, over the untraced tail's passes
(``extract.pass`` reports)."""

from benchmark.metrics._program import gap_share


def read(run):
    return gap_share("extract")
