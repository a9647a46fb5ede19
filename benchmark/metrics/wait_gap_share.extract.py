"""The part of the extraction loop's device gaps put down to
``extract.wait`` (the main thread blocked on the decode thread's queue)
over the passes' wall time, in percent."""

from benchmark.metrics._program import gap_share


def read(run):
    return gap_share("extract", ("extract.wait",))
