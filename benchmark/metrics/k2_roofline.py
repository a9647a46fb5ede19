"""Kernel 2 (the fused inference bottleneck stack, stage 1 of ResNet-50):
the least time of stage 1 on the images of the feature-program calls that
launched it, over its device time in the trace, in percent."""

from benchmark.frozen import flops
from benchmark.metrics._kernels import K2, roofline


def read(run):
    return roofline(run, "features", K2, "any", lambda cfg, n: (
        flops.infer_stack_work(flops.stage1(cfg["width"], cfg["crop_size"],
                                            cfg["stage_sizes"][0]), n)))
