"""The EOVC reader's rate on the decode thread: the bytes it returned
(``eovc.bytes``) over the seconds inside its ``read`` spans, over the
untraced tail's passes, in GB/s."""

from benchmark.metrics._program import tail


def read(run):
    reps = tail("extract")
    nbytes = sum(r["counters"].get("eovc.bytes", 0) for r in reps)
    seconds = sum(r["spans"].get("read", {}).get("s", 0.0) for r in reps)
    if not nbytes or seconds <= 0:
        return None
    return nbytes / seconds / 1e9
