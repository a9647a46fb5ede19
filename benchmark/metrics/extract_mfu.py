"""The feature program's share of the chip's dense bf16 peak: the analytic
forward FLOPs (no head) of every image whose clip was stored in the window,
over the window and the peak, in percent."""

from benchmark.metrics._shares import mfu


def read(run):
    return mfu(run, 1, head=False)
