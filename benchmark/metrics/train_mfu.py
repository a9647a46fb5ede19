"""The train step's share of the chips' dense bf16 peak: 3 x the analytic
forward FLOPs (with the fc head) of every image trained in the window, all
ranks, over the window and the chips' peak, in percent."""

from benchmark.metrics._shares import mfu


def read(run):
    return mfu(run, 3, head=True)
