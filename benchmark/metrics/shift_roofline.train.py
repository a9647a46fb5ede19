"""The temporal shift's kernel (forward and adjoint): the least time of
the bytes the shift must move (``_tsm_nl``) on the step's images over the
HBM bandwidth, over its kernels' device time in the trace (launches from
the step's thread and autograd's), in percent."""

import re

from benchmark.metrics._kernels import roofline
from benchmark.metrics._tsm_nl import shift_bytes_per_image

SHIFT = re.compile(r"\btemporal_shift_kernel\b")


def read(run):
    return roofline(run, "step", SHIFT, "any", lambda cfg, n: (
        0.0, float(n * shift_bytes_per_image(cfg))))
