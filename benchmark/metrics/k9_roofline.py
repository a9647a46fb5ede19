"""Kernel 9 (the train stack's backward: recompute, input gradient, weight
gradients): the least time of both stacks' backward on the step's images
over the device time of its launches (autograd's backward thread) in the
trace, in percent."""

from benchmark.frozen import flops
from benchmark.metrics._kernels import K9, roofline, train_stacks


def read(run):
    return roofline(run, "step", K9, "other", lambda cfg, n: (
        flops.train_backward_work(train_stacks(cfg), n)))
