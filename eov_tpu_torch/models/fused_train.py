"""Stem / slice views of the train ResNet for the fused train route.

Counterpart of ``eov_tpu/models/fused_train.py``. The fused route runs

    stem -> fused stage 1 -> layer2.0 -> fused stage-2 tail -> tail

where the fused stacks are ``ops.bottleneck_train.bottleneck_stack_train``
(kernels 8 and 9 on the GPU) and the rest is the monolith's own modules.
``ResNetStem`` and ``ResNetSlice`` own no parameters: they run the named
modules of one ``models.resnet.ResNet``, so a single module tree and a
single ``state_dict`` serve the fused and the unfused route, the optimizer
and the checkpoints alike (the reference gets the same property from flax
module names).

Only the ``partial_bn=True`` regime is supported: the stage BNs must be
frozen (constant affines) for the fused backward to be exact; the train
step enforces it when it resolves ``fused_stage1``.

The stem's two train levers (``TrainConfig.stem_s2d`` / ``pool_vjp``,
the reference's ``ResNetStem(s2d=, pool_vjp=)``): ``_S2DConv1`` computes
the 7x7/s2 stem conv by the space-to-depth rewrite from the ORIGINAL
``conv1.weight`` [64, 3, 7, 7], refolded inside the forward, so autograd
gives that parameter's own gradient and the checkpoint and optimizer do
not change; ``pool_vjp`` runs the stem pool through
``ops.pool.maxpool_3x3_s2_vjp``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from eov_tpu_torch.models.resnet import ResNet, s2d_frames, s2d_kernel
from eov_tpu_torch.ops.bottleneck_train import (bottleneck_stack_train,
                                                pack_train_block)
from eov_tpu_torch.ops.pool import maxpool_3x3_s2_vjp

__all__ = ["ResNetStem", "ResNetSlice", "stage_block_specs", "FusedStack"]


class _View(nn.Module):
    """Runs modules of a ResNet it does not own (not a registered child, so
    it adds nothing to any state_dict)."""

    def __init__(self, model: ResNet):
        super().__init__()
        object.__setattr__(self, "model", model)


class _S2DConv1(_View):
    """The stem conv of ``model.conv1`` through the space-to-depth rewrite:
    NHWC [N, H, W, 3] (H, W even) -> NCHW [N, O, H/2, W/2] in the compute
    dtype, the 7x7/s2/p3 conv's value up to summation order."""

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        conv = self.model.conv1
        return F.conv2d(s2d_frames(x_nhwc).to(conv.dtype),
                        s2d_kernel(conv.weight).to(conv.dtype))


class ResNetStem(_View):
    """conv1 -> bn1 (the one BN that trains) -> relu -> 3x3/s2 maxpool;
    ``s2d`` computes conv1 by ``_S2DConv1``, ``pool_vjp`` pools through
    ``ops.pool.maxpool_3x3_s2_vjp``."""

    def __init__(self, model: ResNet, s2d: bool = False,
                 pool_vjp: bool = False):
        super().__init__(model)
        self.s2d, self.pool_vjp = s2d, pool_vjp

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        m = self.model
        x = x_nhwc.to(m.dtype)
        x = (_S2DConv1(m)(x) if self.s2d
             else m.conv1(x.permute(0, 3, 1, 2)))
        x = torch.relu(m.bn1(x))
        if not self.pool_vjp:
            return F.max_pool2d(x, 3, 2, 1)  # implicit -inf padding
        return maxpool_3x3_s2_vjp(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ResNetSlice(_View):
    """A run of the monolith's blocks, by name, optionally followed by the
    head (pool -> dropout -> fc)."""

    def __init__(self, model: ResNet, blocks: Sequence[tuple],
                 head: bool = False):
        super().__init__(model)
        self.names = [name for name, _, _ in blocks]
        self.has_head = head

    def forward(self, x: torch.Tensor,
                noise: torch.Tensor | None = None) -> torch.Tensor:
        for name in self.names:
            x = self.model.run_block(name, x)
        return self.model.head(x, noise) if self.has_head else x


class FusedStack(_View):
    """The stride-1 blocks ``names`` as one fused train stack over an NCHW
    (channels_last) map; the block input and output are f32."""

    def __init__(self, model: ResNet, names: Sequence[str]):
        super().__init__(model)
        self.names = list(names)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        blocks = [pack_train_block(self.model.get_submodule(t))
                  for t in self.names]
        flat = x.float().permute(0, 2, 3, 1).reshape(n, h * w, c)
        y = bottleneck_stack_train(flat.contiguous(), blocks, h=h, w=w,
                                   dtype=self.model.dtype)
        return y.reshape(n, h, w, -1).permute(0, 3, 1, 2)


def stage_block_specs(stage_sizes: Sequence[int], width: int,
                      stages: Sequence[int]) -> list[tuple]:
    """(name, filters, stride) of every block of the given 1-based stages,
    under the monolith's names (``layer{i}.{j}``)."""
    return [(f"layer{i + 1}.{j}", width * 2 ** i, 2 if i > 0 and j == 0
             else 1)
            for i, n_blocks in enumerate(stage_sizes) if i + 1 in stages
            for j in range(n_blocks)]
