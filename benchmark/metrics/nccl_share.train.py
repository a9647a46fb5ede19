"""The collectives' share of rank 0's device time: the NCCL kernels'
device seconds in the trace over its busy seconds, in percent. A
collective's kernel starts when this rank reaches it and ends when the last
rank has, so its time holds the wait for the slowest rank (their skew)
beside the transfer."""


def read(run):
    tr = run.prof_trace
    if tr is None or tr.busy_s <= 0:
        return None
    s = tr.seconds_of(lambda name: "nccl" in name.lower())
    return 100.0 * s / tr.busy_s if s > 0 else None
