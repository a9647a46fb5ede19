"""Folded-BN ResNet inference forward with fused stages.

Counterpart of ``eov_tpu/models/folded_infer.py:folded_feature_apply``.
Frames ``[..., H, W, 3]`` go to features ``[..., D]`` (float32):

* the stem conv, the ``-inf``-padded 3x3/s2 maxpool and every strided or
  unfused block run as ``F.conv2d`` (cuDNN on the GPU), channels_last,
  just as the reference leaves them to XLA;
* the stages named in ``fused_stages`` run their stride-1 blocks through
  the stack kernels of ``ops.bottleneck``: ``fused_bottleneck_stack``
  (kernel 2) on bottleneck archs, ``fused_basic_stack`` (kernel 4) on
  basic archs (resnet18/34). Stage 1 is stride-1 from its entry, so all of
  it fuses; stages 2-4 run their strided entry block on cuDNN and fuse the
  tail;
* ``pallas_pool=True`` runs the stem pool through
  ``ops.pool.maxpool_3x3_s2_nonneg`` (kernel 6, zero pad: exact on the
  post-ReLU map); ``pallas_pool="fused"`` hands the pre-pool map to the
  stage-1 stack, which pools at its entry
  (``fused_pool_bottleneck_stack``, kernel 5; bottleneck archs with stage 1
  fused only);
* ``stem_s2d=True`` runs the stem as a 4x4 stride-1 conv with padding
  (2, 1) over the space-to-depth frames ``[..., H/2, W/2, 12]``; the
  weights must come through ``models.resnet.space_to_depth_stem``.

Rounding follows the reference: each conv's output rounds to the compute
dtype, then bias (in the compute dtype) and ReLU; residual adds in the
compute dtype on unfused blocks; the fused stacks follow their own chains
(ops/bottleneck.py). The global pool averages in f32 and rounds to the
compute dtype before the final widening, as ``jnp.mean`` does.

float32 compute turns TF32 off for cuDNN convs and matmuls
(``use_full_f32``): TF32 keeps ~3 decimal digits, and the reference's f32
program is full f32. In bf16 the convs run in bf16 as XLA's do.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from eov_tpu_torch.models import get_arch
from eov_tpu_torch.models.resnet import block_names, s2d_frames
from eov_tpu_torch.ops.bottleneck import (fused_basic_stack,
                                          fused_bottleneck_stack,
                                          fused_pool_bottleneck_stack,
                                          pack_basic_params,
                                          pack_bottleneck_params)
from eov_tpu_torch.ops.pool import maxpool_3x3_s2_nonneg

__all__ = ["FoldedResNet", "folded_feature_apply", "resolve_fused_stages",
           "use_full_f32"]

PALLAS_POOL = (False, True, "fused")


def use_full_f32() -> None:
    """Full-precision float32 on the GPU: no TF32 in cuDNN convs or in
    matmuls (PyTorch lets cuDNN use TF32 by default)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_fused_stages(fused_stages, *, arch: str,
                         folded: bool = True) -> tuple:
    """"auto" -> (1,) for bottleneck archs on every device (the op picks
    kernel or plain version by the tensor's device), () for basic archs, as
    the reference resolves it. Explicit tuples are honored on both
    families. Without the BN fold (``folded=False``) nothing fuses: ()."""
    stage_sizes, bottleneck = get_arch(arch)
    if not folded:
        return ()
    if fused_stages == "auto":
        return (1,) if bottleneck else ()
    stages = tuple(int(s) for s in (fused_stages or ()))
    bad = [s for s in stages if not 1 <= s <= len(stage_sizes)]
    if bad:
        raise ValueError(f"fused_stages {bad} out of range for {arch}")
    return stages


class FoldedResNet(nn.Module):
    """The folded inference network; weights cast to ``dtype`` once.

    ``folded`` is ``models.resnet.fold_batchnorm`` output (of
    ``space_to_depth_stem`` weights with ``stem_s2d``). Conv weights are
    kept channels_last, fused-stage blocks pre-packed for the stack kernels.
    """

    def __init__(self, folded: Mapping, *, arch: str = "resnet50",
                 dtype=torch.bfloat16, fused_stages=(1,),
                 pallas_pool=False, stem_s2d: bool = False):
        super().__init__()
        self.arch = arch
        self.dtype = dtype
        self.stage_sizes, self.bottleneck = get_arch(arch)
        self.fused_stages = resolve_fused_stages(fused_stages, arch=arch)
        if pallas_pool not in PALLAS_POOL:
            raise ValueError(f"pallas_pool={pallas_pool!r}: expected one of "
                             f"{PALLAS_POOL}")
        if pallas_pool == "fused" and not self.bottleneck:
            raise ValueError("pallas_pool='fused' is implemented for "
                             "bottleneck archs only")
        if pallas_pool == "fused" and 1 not in self.fused_stages:
            raise ValueError(
                "pallas_pool='fused' requires stage 1 in fused_stages (got "
                f"{fused_stages!r}); use pallas_pool=True for the "
                "standalone kernel")
        self.pallas_pool = pallas_pool if pallas_pool == "fused" else \
            bool(pallas_pool)
        self.stem_s2d = bool(stem_s2d)
        stem = tuple(folded["conv1"]["weight"].shape[1:])
        want = (12, 4, 4) if self.stem_s2d else (3, 7, 7)
        if stem != want:
            raise ValueError(
                f"stem_s2d={self.stem_s2d} needs a stem kernel of shape "
                f"[O, {', '.join(map(str, want))}], got [O, "
                f"{', '.join(map(str, stem))}]" + (
                    " (pass the weights through space_to_depth_stem)"
                    if self.stem_s2d else ""))
        pack = pack_bottleneck_params if self.bottleneck else \
            pack_basic_params
        self._convs: dict[str, tuple[str, str]] = {}
        self._packs: dict[int, list[dict[str, str]]] = {}
        self._add_conv("stem", folded["conv1"])
        for i, j, t in block_names(arch):
            blk = folded[t]
            if (i + 1) in self.fused_stages and (i == 0 or j > 0):
                names = {}
                for k, v in pack(blk, dtype).items():
                    names[k] = f"pack_{t.replace('.', '_')}_{k}"
                    self.register_buffer(names[k], v)
                self._packs.setdefault(i, []).append(names)
            else:
                for c, conv in blk.items():
                    self._add_conv(f"{t}.{c}", conv)

    def _add_conv(self, name: str, conv: Mapping) -> None:
        key = name.replace(".", "_")
        w = conv["weight"].to(self.dtype).contiguous(
            memory_format=torch.channels_last)
        self.register_buffer(f"{key}_w", w)
        self.register_buffer(f"{key}_b",
                             conv["bias"].to(self.dtype).reshape(-1, 1, 1))
        self._convs[name] = (f"{key}_w", f"{key}_b")

    def _conv(self, name, x, stride=1, pad=0):
        w, b = (getattr(self, k) for k in self._convs[name])
        return F.conv2d(x, w, stride=stride, padding=pad) + b

    def _block(self, t: str, x, stride: int):
        if self.bottleneck:
            y = torch.relu(self._conv(f"{t}.conv1", x))
            y = torch.relu(self._conv(f"{t}.conv2", y, stride, 1))
            y = self._conv(f"{t}.conv3", y)
        else:
            y = torch.relu(self._conv(f"{t}.conv1", x, stride, 1))
            y = self._conv(f"{t}.conv2", y, 1, 1)
        r = (self._conv(f"{t}.downsample", x, stride)
             if f"{t}.downsample" in self._convs else x)
        return torch.relu(y + r)

    def _stack(self, i: int, x):
        blocks = [{k: getattr(self, v) for k, v in names.items()}
                  for names in self._packs[i]]
        nhwc = x.permute(0, 2, 3, 1).contiguous()
        n, h, w, c = nhwc.shape
        if i == 0 and self.pallas_pool == "fused":
            h, w = h // 2, w // 2  # the stack pools at its entry
            y = fused_pool_bottleneck_stack(nhwc, blocks)
        elif self.bottleneck:
            y = fused_bottleneck_stack(nhwc.reshape(n, h * w, c), blocks,
                                       h=h, w=w)
        else:
            y = fused_basic_stack(nhwc.reshape(n, h * w, c), blocks, h=h,
                                  w=w)
        return y.reshape(n, h, w, -1).permute(0, 3, 1, 2)

    def _stem(self, x):
        """NHWC frames [B, H, W, 3] -> the post-ReLU stem map (NCHW view of
        channels_last memory)."""
        if not self.stem_s2d:
            return torch.relu(self._conv("stem", x.permute(0, 3, 1, 2), 2, 3))
        return torch.relu(self._conv("stem", s2d_frames(x)))

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32 and frames.is_cuda:
            use_full_f32()
        lead = frames.shape[:-3]
        # NHWC memory viewed as NCHW: a channels_last tensor, no copy.
        x = self._stem(frames.reshape(-1, *frames.shape[-3:]).to(self.dtype))
        if self.pallas_pool is True:
            x = maxpool_3x3_s2_nonneg(x.permute(0, 2, 3, 1).contiguous())
            x = x.permute(0, 3, 1, 2)
        elif not self.pallas_pool:
            x = F.max_pool2d(x, 3, 2, 1)  # implicit -inf padding
        for i, n_blocks in enumerate(self.stage_sizes):
            if i in self._packs:
                if i > 0:
                    x = self._block(f"layer{i + 1}.0", x, 2)
                x = self._stack(i, x)
                continue
            for j in range(n_blocks):
                x = self._block(f"layer{i + 1}.{j}", x,
                                2 if (i > 0 and j == 0) else 1)
        feats = x.mean(dim=(2, 3), dtype=torch.float32).to(self.dtype)
        return feats.float().reshape(*lead, -1)


def folded_feature_apply(folded: Mapping, frames: torch.Tensor, *,
                         arch: str = "resnet50", dtype=torch.bfloat16,
                         fused_stages=(1,), pallas_pool=False,
                         stem_s2d: bool = False) -> torch.Tensor:
    """Functional form: frames [..., H, W, 3] -> features [..., D] on the
    frames' device."""
    net = FoldedResNet(folded, arch=arch, dtype=dtype,
                       fused_stages=fused_stages, pallas_pool=pallas_pool,
                       stem_s2d=stem_s2d).to(frames.device)
    return net(frames)
