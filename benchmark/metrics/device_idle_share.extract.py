"""The device's idle share of the traced window: 1 - the union of kernel,
memcpy and memset intervals over the window, rank 0's, in percent."""

from benchmark.metrics._shares import idle


def read(run):
    return idle(run)
