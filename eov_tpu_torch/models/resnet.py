"""ResNet for the port: weights, BN folding, carry-over, the train model.

The port's weights are a torchvision-style ResNet ``state_dict`` (OIHW conv
weights, BatchNorm ``weight/bias/running_mean/running_var``, an optional
``fc`` head) of float32 tensors. This module gets them three ways:

* ``from_jax_variables`` — from the JAX reference's flax ``{params,
  batch_stats}`` tree (as numpy arrays): HWIO -> OIHW, flax names ->
  torchvision names. Every parity test feeds both packages this way.
* ``load_state_dict`` — a torchvision checkpoint (``.pth``) or an ``.npz``
  of the same names, checked against the arch (counterpart of
  ``eov_tpu/tools/port_torch.py:port_resnet_state_dict``).
* ``random_state_dict`` — seeded random weights from a ``torch.Generator``.

``space_to_depth_stem`` rewrites the 7x7/s2 stem kernel for the
space-to-depth stem (counterpart of
``eov_tpu/models/resnet.py:space_to_depth_stem``).

``fold_batchnorm`` is the port's own inference BN fold (counterpart of
``eov_tpu/models/resnet.py:fold_batchnorm``): with s = gamma/sqrt(var+eps),
BN(conv(x)) = conv'(x) + b' where W' = W*s and b' = beta - mean*s, computed
in float32 exactly as the reference does (bit for bit: the int8 path's
weight scales depend on it).

``ResNet`` is the trainable network of the finetune path (counterpart of
``eov_tpu/models/resnet.py:ResNet`` with ``num_classes``), an ``nn.Module``
whose ``state_dict`` carries exactly the torchvision names above, so a
state_dict from ``from_jax_variables`` (a flax TRAIN state, fc included)
loads into it unchanged. Its numerics are the flax model's:

* NHWC at its surface, channels_last memory inside.
* Every conv casts its input and kernel to the compute dtype and rounds
  its output to it (f32 accumulation); BatchNorm runs in f32 on that and
  outputs f32, so residual adds and block outputs are f32.
* BatchNorm is flax's: ``(x - mean) * (rsqrt(var + eps) * gamma) + beta``;
  in training, batch statistics with the BIASED variance ``E[x^2] -
  E[x]^2`` (clamped at 0) and running averages ``0.9 ra + 0.1 batch``, the
  biased variance included (``torch.nn.BatchNorm2d`` would store the
  unbiased one, with the opposite meaning of momentum).
* ``partial_bn`` (TSN): the stem ``bn1`` trains; every other BN is frozen
  on its running statistics, affine included (``requires_grad=False``).
* Global mean pool in f32, dropout (mask from an explicit generator), f32
  ``fc``.
* ``remat`` recomputes each residual block in the backward
  (``torch.utils.checkpoint``); a running-statistics update is applied once,
  on the first of the two forwards.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from eov_tpu_torch.models import get_arch

__all__ = ["from_jax_variables", "load_state_dict", "check_state_dict",
           "random_state_dict", "space_to_depth_stem", "fold_batchnorm",
           "block_names",
           "Conv", "BatchNorm", "Bottleneck", "BasicBlock", "ResNet"]

_BN_STATS = ("weight", "bias", "running_mean", "running_var")


def block_names(arch: str):
    """[(stage index 0.., block index, "layer{i}.{j}")] in forward order."""
    stage_sizes, _ = get_arch(arch)
    return [(i, j, f"layer{i + 1}.{j}")
            for i, n in enumerate(stage_sizes) for j in range(n)]


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def from_jax_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """flax ResNet variables {params, batch_stats} -> torchvision state_dict.

    Names ``layer{i}_{j}/convK`` map to ``layer{i}.{j}.convK``,
    ``downsample_conv``/``downsample_bn`` to ``downsample.0``/``.1``.
    """
    p, s = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}

    def conv(name, kernel):
        sd[f"{name}.weight"] = _t(kernel).permute(3, 2, 0, 1).contiguous()

    def bn(prefix, bp, bs):
        sd[f"{prefix}.weight"] = _t(bp["scale"])
        sd[f"{prefix}.bias"] = _t(bp["bias"])
        sd[f"{prefix}.running_mean"] = _t(bs["mean"])
        sd[f"{prefix}.running_var"] = _t(bs["var"])

    conv("conv1", p["conv1"]["kernel"])
    bn("bn1", p["bn1"], s["bn1"])
    for name in sorted(k for k in p if k.startswith("layer")):
        t = name.replace("_", ".")
        blk, st = p[name], s[name]
        for c in sorted(k for k in blk if k.startswith("conv")):
            conv(f"{t}.{c}", blk[c]["kernel"])
            bn(f"{t}.bn{c[4:]}", blk[f"bn{c[4:]}"], st[f"bn{c[4:]}"])
        if "downsample_conv" in blk:
            conv(f"{t}.downsample.0", blk["downsample_conv"]["kernel"])
            bn(f"{t}.downsample.1", blk["downsample_bn"], st["downsample_bn"])
    if "fc" in p:
        sd["fc.weight"] = _t(p["fc"]["kernel"]).t().contiguous()
        sd["fc.bias"] = _t(p["fc"]["bias"])
    return sd


def _expected_keys(arch: str, sd: Mapping) -> list[str]:
    _, bottleneck = get_arch(arch)
    keys = ["conv1.weight"] + [f"bn1.{k}" for k in _BN_STATS]
    n_convs = 3 if bottleneck else 2
    for _, _, t in block_names(arch):
        for c in range(1, n_convs + 1):
            keys.append(f"{t}.conv{c}.weight")
            keys += [f"{t}.bn{c}.{k}" for k in _BN_STATS]
        if f"{t}.downsample.0.weight" in sd:
            keys.append(f"{t}.downsample.0.weight")
            keys += [f"{t}.downsample.1.{k}" for k in _BN_STATS]
    return keys


def check_state_dict(sd: Mapping, arch: str, strict: bool = True) -> dict:
    """Validate a torchvision ResNet state_dict for ``arch``; return the
    float32 tensors the forward uses.

    strict=True refuses leftover parameter keys the arch never consumes (a
    checkpoint of another depth would otherwise be silently truncated);
    BN ``num_batches_tracked`` and the fc head are expected leftovers.
    """
    keys = _expected_keys(arch, sd)
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"state_dict lacks {len(missing)} keys for {arch}, "
                       f"e.g. {missing[:4]}")
    if strict:
        used = set(keys)
        leftover = sorted(k for k in sd if k not in used
                          and not k.endswith("num_batches_tracked")
                          and k not in ("fc.weight", "fc.bias"))
        if leftover:
            raise ValueError(
                f"state_dict has {len(leftover)} unconsumed parameter keys "
                f"for {arch}, e.g. {leftover[:4]} — a checkpoint of a "
                "different resnet?")
    return {k: _t(sd[k]) for k in keys}


def load_state_dict(path: str, arch: str = "resnet50") -> dict:
    """Weights from a torchvision ``.pth``/``.pt`` or a same-named ``.npz``."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            sd = {k: z[k] for k in z.files}
    elif path.endswith((".pth", ".pt")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
    else:
        raise ValueError(f"--params must be .npz, .pth or .pt, got {path}")
    return check_state_dict(sd, arch)


def random_state_dict(arch: str = "resnet50", seed: int = 0,
                      width: int = 64, num_classes: int | None = None) -> dict:
    """Seeded random weights: conv kernels ~ N(0, 1/fan_in) (LeCun normal,
    the flax default), BatchNorm at its init (gamma 1, beta 0, mean 0,
    var 1), and with ``num_classes`` an fc head (weight ~ N(0, 1/fan_in),
    bias 0). Drawn from a ``torch.Generator`` on the CPU."""
    stage_sizes, bottleneck = get_arch(arch)
    g = torch.Generator().manual_seed(int(seed))
    sd: dict[str, torch.Tensor] = {}

    def conv(name, cout, cin, k):
        std = 1.0 / math.sqrt(cin * k * k)
        sd[f"{name}.weight"] = torch.randn(cout, cin, k, k, generator=g) * std

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = torch.ones(c)
        sd[f"{prefix}.bias"] = torch.zeros(c)
        sd[f"{prefix}.running_mean"] = torch.zeros(c)
        sd[f"{prefix}.running_var"] = torch.ones(c)

    conv("conv1", width, 3, 7)
    bn("bn1", width)
    cin = width
    for i, j, t in block_names(arch):
        f = width * 2 ** i
        cout = 4 * f if bottleneck else f
        if bottleneck:
            convs = [(f, cin, 1), (f, f, 3), (cout, f, 1)]
        else:
            convs = [(f, cin, 3), (f, f, 3)]
        for c, (o, ci, k) in enumerate(convs, start=1):
            conv(f"{t}.conv{c}", o, ci, k)
            bn(f"{t}.bn{c}", o)
        if cin != cout or (i > 0 and j == 0):
            conv(f"{t}.downsample.0", cout, cin, 1)
            bn(f"{t}.downsample.1", cout)
        cin = cout
    if num_classes is not None:
        sd["fc.weight"] = torch.randn(num_classes, cin,
                                      generator=g) / math.sqrt(cin)
        sd["fc.bias"] = torch.zeros(num_classes)
    return sd


def space_to_depth_stem(sd: Mapping) -> dict:
    """Rewrite ``conv1.weight`` [O, 3, 7, 7] -> [O, 12, 4, 4] for the
    space-to-depth stem (``FoldedResNet(stem_s2d=True)``); other entries
    pass through, as does an already rewritten stem.

    Exact: pad the 7x7 to 8x8 with a zero top row and left column, then
    fold each (dy, dx) phase of the 2x2 stride with the 3 colours into
    12 input channels in the s2d input's (dy, dx, c) order:
    W'[o, dy*6 + dx*3 + c, a, b] = W8[o, c, 2a + dy, 2b + dx]. A 4x4
    stride-1 conv with padding (2, 1) over the s2d frames then equals the
    7x7 stride-2 pad-3 conv up to summation order. It commutes with
    ``fold_batchnorm`` (both only scale or move kernel entries).
    """
    out = dict(sd)
    k = out["conv1.weight"]
    if tuple(k.shape[1:]) == (3, 7, 7):
        k = F.pad(k, (1, 0, 1, 0))  # [O, 3, 8, 8]
        o = k.shape[0]
        # [o, c, a, dy, b, dx] -> [o, dy, dx, c, a, b]
        k = k.reshape(o, 3, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
        out["conv1.weight"] = k.reshape(o, 12, 4, 4).contiguous()
    return out


def _fold(sd, conv: str, bn: str, eps: float) -> dict:
    # The square root is taken in float64 and rounded once to float32: the
    # correctly rounded f32 root, which XLA computes and the CPU's
    # vectorized f32 sqrt does not always give.
    root = torch.sqrt((sd[f"{bn}.running_var"] + eps).double()).float()
    scale = sd[f"{bn}.weight"] / root
    return {
        "weight": sd[f"{conv}.weight"] * scale[:, None, None, None],
        "bias": sd[f"{bn}.bias"] - sd[f"{bn}.running_mean"] * scale,
    }


def fold_batchnorm(sd: Mapping, arch: str = "resnet50",
                   eps: float = 1e-5) -> dict:
    """state_dict -> folded {"conv1": {weight, bias}, "layer1.0": {"conv1":
    {weight, bias}, ..., ["downsample": {weight, bias}]}, ...} in float32."""
    sd = check_state_dict(sd, arch, strict=False)
    _, bottleneck = get_arch(arch)
    n_convs = 3 if bottleneck else 2
    out = {"conv1": _fold(sd, "conv1", "bn1", eps)}
    for _, _, t in block_names(arch):
        blk = {f"conv{c}": _fold(sd, f"{t}.conv{c}", f"{t}.bn{c}", eps)
               for c in range(1, n_convs + 1)}
        if f"{t}.downsample.0.weight" in sd:
            blk["downsample"] = _fold(sd, f"{t}.downsample.0",
                                      f"{t}.downsample.1", eps)
        out[t] = blk
    return out


# ------------------------------------------------------- the train model

_BN_MOMENTUM = 0.9  # flax's: ra = 0.9 * ra + (1 - 0.9) * batch
_BN_EPS = 1e-5


class Conv(nn.Module):
    """Bias-free conv in the compute dtype: input and kernel cast to
    ``dtype``, output rounded to it (flax ``nn.Conv(dtype=...)``)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        stride=self.stride, padding=self.padding)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)`` over
    NCHW; ``frozen`` keeps it on running statistics in training too."""

    def __init__(self, c: int, frozen: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c), requires_grad=not frozen)
        self.bias = nn.Parameter(torch.zeros(c), requires_grad=not frozen)
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.frozen = frozen
        self.update_stats = True  # off while remat recomputes the forward

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training and not self.frozen:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean,
                                  0.0)
            if self.update_stats:
                with torch.no_grad():
                    m = _BN_MOMENTUM
                    self.running_mean.copy_(m * self.running_mean
                                            + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var
                                           + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + _BN_EPS) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class Bottleneck(nn.Module):
    """ResNet v1.5 bottleneck: 1x1 -> 3x3 (stride here) -> 1x1, + shortcut."""

    def __init__(self, cin: int, filters: int, stride: int, dtype,
                 frozen: bool):
        super().__init__()
        cout = 4 * filters
        self.conv1 = Conv(cin, filters, 1, dtype=dtype)
        self.bn1 = BatchNorm(filters, frozen)
        self.conv2 = Conv(filters, filters, 3, stride, 1, dtype=dtype)
        self.bn2 = BatchNorm(filters, frozen)
        self.conv3 = Conv(filters, cout, 1, dtype=dtype)
        self.bn3 = BatchNorm(cout, frozen)
        self.downsample = (nn.Sequential(Conv(cin, cout, 1, stride,
                                              dtype=dtype),
                                         BatchNorm(cout, frozen))
                           if cin != cout or stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = self.downsample(x) if self.downsample is not None else x.float()
        return torch.relu(y + r)


class BasicBlock(nn.Module):
    """ResNet basic block (18/34): 3x3 (stride) -> 3x3, + shortcut."""

    def __init__(self, cin: int, filters: int, stride: int, dtype,
                 frozen: bool):
        super().__init__()
        self.conv1 = Conv(cin, filters, 3, stride, 1, dtype=dtype)
        self.bn1 = BatchNorm(filters, frozen)
        self.conv2 = Conv(filters, filters, 3, 1, 1, dtype=dtype)
        self.bn2 = BatchNorm(filters, frozen)
        self.downsample = (nn.Sequential(Conv(cin, filters, 1, stride,
                                              dtype=dtype),
                                         BatchNorm(filters, frozen))
                           if cin != filters or stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        r = self.downsample(x) if self.downsample is not None else x.float()
        return torch.relu(y + r)


def _remat(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """block(x) with its activations recomputed in the backward; the
    recompute applies no running-statistics update."""
    calls = []

    def run(inp):
        if not calls:
            calls.append(1)
            return block(inp)
        bns = [m for m in block.modules() if isinstance(m, BatchNorm)]
        for bn in bns:
            bn.update_stats = False
        try:
            return block(inp)
        finally:
            for bn in bns:
                bn.update_stats = True

    return checkpoint(run, x, use_reentrant=False)


class ResNet(nn.Module):
    """The trainable ResNet (NHWC in, logits or pooled features out)."""

    def __init__(self, arch: str = "resnet50", num_classes: int | None = None,
                 width: int = 64, dtype=torch.float32,
                 partial_bn: bool = False, dropout: float = 0.0,
                 remat: bool = False):
        super().__init__()
        self.arch, self.dtype = arch, dtype
        self.stage_sizes, bottleneck = get_arch(arch)
        self.dropout, self.remat = dropout, remat
        block_cls = Bottleneck if bottleneck else BasicBlock
        self.conv1 = Conv(3, width, 7, 2, 3, dtype=dtype)
        self.bn1 = BatchNorm(width)  # the stem BN trains under partial_bn
        cin = width
        for i, n_blocks in enumerate(self.stage_sizes):
            blocks = []
            for j in range(n_blocks):
                blocks.append(block_cls(cin, width * 2 ** i,
                                        2 if i > 0 and j == 0 else 1, dtype,
                                        frozen=partial_bn))
                cin = width * 2 ** i * (4 if bottleneck else 1)
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, num_classes) if num_classes else None

    def stem(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] -> the pooled stem map, f32 NCHW (channels_last)."""
        x = x_nhwc.to(self.dtype).permute(0, 3, 1, 2)
        x = torch.relu(self.bn1(self.conv1(x)))
        return F.max_pool2d(x, 3, 2, 1)  # implicit -inf padding

    def run_block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        block = self.get_submodule(name)
        if self.remat and self.training and torch.is_grad_enabled():
            return _remat(block, x)
        return block(x)

    def head(self, x: torch.Tensor,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """Global mean pool (f32) -> dropout -> fc (f32)."""
        x = x.float().mean(dim=(2, 3))
        if self.fc is None:
            return x
        if self.training and self.dropout > 0:
            keep = torch.rand(x.shape, generator=generator,
                              device=x.device) < 1.0 - self.dropout
            x = torch.where(keep, x / (1.0 - self.dropout),
                            torch.zeros_like(x))
        return self.fc(x)

    def forward(self, x_nhwc: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.stem(x_nhwc)
        for _, _, t in block_names(self.arch):
            x = self.run_block(t, x)
        return self.head(x, generator)
