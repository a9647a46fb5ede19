"""The part of the train loop's device gaps put down to ``train.keys``
(the step's threefry draws on the host: the key split, the dropout seed,
the multiscale crop's picks) over the epochs' wall time, in percent."""

from benchmark.metrics._program import gap_share


def read(run):
    return gap_share("train", ("train.keys",))
