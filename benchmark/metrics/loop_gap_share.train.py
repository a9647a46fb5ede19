"""The part of the train loop's device gaps put down to the loop around
the step: the reader (``read``), the batch's stack, pin and key split
(``train.batch``) and the epoch's own code (``train.epoch``'s self time),
over the epochs' wall time, in percent."""

from benchmark.metrics._program import gap_share


def read(run):
    return gap_share("train", ("read", "train.batch", "train.epoch"))
