"""Operations and bytes of the work the cells ask for, from their shapes.

``resnet_forward_flops`` is copied from ``eov_tpu_torch/utils/flops.py`` at
commit 1d21111, taking the stage sizes and block kind from the
configuration instead of the program's registry: 2 FLOPs per
multiply-accumulate, convolutions and the fc head only (ResNet-50 at 224² is
8.18 GFLOP an image).

The stack counts are those of ``chip_smoke.py`` at commit 1d21111
(``stack_flops_per_img`` of ``eov_tpu_torch/ops/bottleneck.py``, the byte
counts of ``check_stack`` and ``check_train_stack``): a stack of bottleneck
blocks reads its input once and writes its output once, and reads each
weight once; the train backward reads x and the output gradient, writes the
input gradient, and reads and writes each weight once; its operations are
three times the forward's (recompute, input gradient, weight gradients).
They count what these shapes need, whatever implements it.
"""

from __future__ import annotations


def _conv_out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def resnet_forward_flops(stage_sizes, bottleneck: bool, hw=(224, 224), *,
                         num_classes: int | None = None,
                         width: int = 64) -> int:
    """Forward conv (+ fc) FLOPs of ONE image through the backbone."""
    h, w = hw
    flops = 0

    def add_conv(h, w, in_c, out_c, k, s, pad):
        nonlocal flops
        oh, ow = _conv_out(h, k, s, pad), _conv_out(w, k, s, pad)
        flops += 2 * oh * ow * out_c * k * k * in_c
        return oh, ow

    h, w = add_conv(h, w, 3, width, 7, 2, 3)
    h, w = _conv_out(h, 3, 2, 1), _conv_out(w, 3, 2, 1)
    c = width
    for i, n_blocks in enumerate(stage_sizes):
        f = width * 2 ** i
        out_c = f * 4 if bottleneck else f
        for j in range(n_blocks):
            s = 2 if i > 0 and j == 0 else 1
            h2, w2 = _conv_out(h, 3, s, 1), _conv_out(w, 3, s, 1)
            if bottleneck:
                add_conv(h, w, c, f, 1, 1, 0)
                flops += 2 * h2 * w2 * f * 9 * f
                flops += 2 * h2 * w2 * out_c * f
            else:
                flops += 2 * h2 * w2 * f * 9 * c
                flops += 2 * h2 * w2 * f * 9 * f
            if c != out_c or s != 1:
                flops += 2 * h2 * w2 * out_c * c
            h, w, c = h2, w2, out_c
    if num_classes is not None:
        flops += 2 * c * num_classes
    return flops


def bottleneck_stack(p: int, cin: int, cmid: int, cout: int, n_blocks: int,
                     proj_first: bool) -> dict:
    """One image through a stack of stride-1 bottleneck blocks of p pixels:
    {"flops", "act_in", "act_out" (channels), "weights" (values)}."""
    flops = weights = 0
    c = cin
    for j in range(n_blocks):
        proj = proj_first and j == 0
        flops += 2 * p * (c * cmid + 9 * cmid * cmid + cmid * cout)
        weights += c * cmid + 9 * cmid * cmid + cmid * cout
        weights += 2 * (2 * cmid + cout)  # the folded BN's scale and shift
        if proj:
            flops += 2 * p * c * cout
            weights += c * cout + 2 * cout
        c = cout
    return {"flops": flops, "p": p, "cin": cin, "cout": cout,
            "weights": weights}


def stage1(width: int = 64, hw: int = 224, n_blocks: int = 3) -> dict:
    """ResNet-50 stage 1: 56² at a 224² crop, 64 -> 64 -> 256."""
    side = hw // 4
    return bottleneck_stack(side * side, width, width, 4 * width, n_blocks,
                            proj_first=True)


def stage2_tail(width: int = 64, hw: int = 224, n_blocks: int = 3) -> dict:
    """The stride-1 blocks of stage 2 (layer2.1..): 28², 512 -> 128 -> 512."""
    side = hw // 8
    c = 8 * width
    return bottleneck_stack(side * side, c, 2 * width, c, n_blocks,
                            proj_first=False)


def infer_stack_work(stack: dict, images: int) -> tuple[float, float]:
    """(operations, bytes) of the bf16 inference stack (kernel 2) over
    ``images``: bf16 activations in and out, bf16 weights, f32 shifts."""
    act = images * stack["p"] * (stack["cin"] + stack["cout"]) * 2
    return float(images * stack["flops"]), float(act + stack["weights"] * 2)


def train_forward_work(stacks, images: int) -> tuple[float, float]:
    """(operations, bytes) of the train stacks' forward (kernel 8) over
    ``images``: f32 activations in and out, f32 weights."""
    ops = byts = 0
    for s in stacks:
        ops += images * s["flops"]
        byts += images * s["p"] * (s["cin"] + s["cout"]) * 4
        byts += s["weights"] * 4
    return float(ops), float(byts)


def train_backward_work(stacks, images: int) -> tuple[float, float]:
    """(operations, bytes) of the train stacks' backward (kernel 9): three
    times the forward's operations; x and the output gradient read, the
    input gradient written (f32), each weight read and its gradient
    written."""
    ops = byts = 0
    for s in stacks:
        ops += 3 * images * s["flops"]
        byts += images * s["p"] * (2 * s["cin"] + s["cout"]) * 4
        byts += 2 * s["weights"] * 4
    return float(ops), float(byts)
