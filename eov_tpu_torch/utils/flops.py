"""Analytic forward FLOPs of the ResNet backbones.

Counterpart of ``eov_tpu/utils/flops.py`` (the same integers for every
arch and input size). The benches divide a step's FLOPs by its measured
time and by the card's peak (``bench/common.py``), so an impossible rate
(an MFU above 1) shows a broken timing fence.

Convention: 2 FLOPs per multiply-accumulate, convolutions and the fc head
only; BN, ReLU and pooling are O(activations) and under 1% of a ResNet
forward. ResNet-50 at 224x224 is 8.17 GFLOP an image (4.09 G MACs).
"""

from __future__ import annotations

from eov_tpu_torch.models import get_arch

__all__ = ["resnet_forward_flops"]


def _conv_out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def resnet_forward_flops(
    arch: str = "resnet50",
    hw: tuple[int, int] = (224, 224),
    *,
    num_classes: int | None = None,
    width: int = 64,
) -> int:
    """Forward conv (+ fc) FLOPs of ONE image through the backbone.

    Follows ``models/resnet.py``: the 7x7/s2 stem (pad 3), the 3x3/s2
    max-pool (pad 1), then each stage's bottleneck blocks (1x1 -> 3x3 with
    the stride -> 1x1, a 1x1 projection) or basic blocks (3x3 with the
    stride -> 3x3, a 1x1 projection), the global average pool, and the fc
    when ``num_classes`` is given.
    """
    stage_sizes, bottleneck = get_arch(arch)
    h, w = hw
    flops = 0

    def add_conv(h, w, in_c, out_c, k, s, pad):
        nonlocal flops
        oh = _conv_out(h, k, s, pad)
        ow = _conv_out(w, k, s, pad)
        flops += 2 * oh * ow * out_c * k * k * in_c
        return oh, ow

    h, w = add_conv(h, w, 3, width, 7, 2, 3)                  # stem
    h, w = _conv_out(h, 3, 2, 1), _conv_out(w, 3, 2, 1)       # max-pool

    c = width
    for i, n_blocks in enumerate(stage_sizes):
        f = width * 2**i
        out_c = f * 4 if bottleneck else f
        for j in range(n_blocks):
            s = 2 if i > 0 and j == 0 else 1
            h2 = _conv_out(h, 3, s, 1)
            w2 = _conv_out(w, 3, s, 1)
            if bottleneck:
                add_conv(h, w, c, f, 1, 1, 0)            # conv1 (input size)
                flops += 2 * h2 * w2 * f * 9 * f          # conv2 (stride)
                flops += 2 * h2 * w2 * out_c * 1 * f      # conv3
            else:
                flops += 2 * h2 * w2 * f * 9 * c          # conv1 (stride)
                flops += 2 * h2 * w2 * f * 9 * f          # conv2
            if c != out_c or s != 1:
                flops += 2 * h2 * w2 * out_c * 1 * c      # projection
            h, w, c = h2, w2, out_c

    if num_classes is not None:
        flops += 2 * c * num_classes
    return flops
