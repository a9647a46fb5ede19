"""Kernel 8 (the train stack's forward: ResNet-50 stage 1 and the stride-1
tail of stage 2): the least time of both stacks' forward on the step's
images over the device time of the forward launches (the step's own
thread) in the trace, in percent."""

from benchmark.frozen import flops
from benchmark.metrics._kernels import K8, roofline, train_stacks


def read(run):
    return roofline(run, "step", K8, "same", lambda cfg, n: (
        flops.train_forward_work(train_stacks(cfg), n)))
