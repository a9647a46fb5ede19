"""The EOVC reader's share of the window: host seconds inside the harness's
spans around each read (``get_frames`` in training, ``get_batch`` on the
extraction loop's decode thread) over the window, in percent."""

from benchmark.metrics._shares import reader


def read(run):
    return reader(run)
