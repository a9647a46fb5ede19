"""What the kernel readers share: which trace kernels are kernels 2, 8 and
9, and the roofline share of the work they did in the traced window.

A kernel's share is the least time of its work on the card (the larger of
operations over the dense bf16 peak and bytes over the memory bandwidth,
``frozen.peaks``) over its device time in the trace, in percent. The work
is counted by ``frozen.flops`` from the configuration's shapes, for the
images of every harness scope that launched the kernel in the trace.
"""

from __future__ import annotations

import re

from benchmark.frozen import flops, peaks

# The bf16 kernels the cells launch; the f32 forms (``bottleneck_block_*``,
# ``train_block_fwd``, ``bwd_dy*``, ``bwd_pre<float>``, ``wgrad_partial``)
# are bound by another peak than the bf16 one these shares take.
# ``reduce_partials`` sums f32 partials for both.
K2 = re.compile(r"\bbottleneck_bf16_kernel\b")
K8 = re.compile(r"\btrain_fwd_bf16\b")
K9 = re.compile(r"\b(train_fwd_bf16\b|bwd_pre<__nv_bfloat16>"
                r"|train_dgrad_bf16\b|wgrad_bf16\b|reduce_partials\b)")


def roofline(run, scope: str, pattern, thread: str, work) -> float | None:
    tr = run.prof_trace
    if tr is None:
        return None
    scopes = tr.scopes(scope)
    seconds, hit = tr.kernels_in(scopes, lambda n: bool(pattern.search(n)),
                                 thread)
    if not hit or seconds <= 0:
        return None
    ops, byts = work(run.cell.config, sum(s["n"] for s in hit))
    least = peaks.least_seconds(ops, byts, run.kind)
    if least is None:
        return None
    return 100.0 * least / seconds


def train_stacks(cfg: dict):
    return [flops.stage1(cfg["width"], cfg["crop_size"]),
            flops.stage2_tail(cfg["width"], cfg["crop_size"],
                              cfg["stage_sizes"][1] - 1)]
