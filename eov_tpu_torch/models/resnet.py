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
* Global mean pool in f32, dropout (mask from a uniform draw the caller
  gives), f32 ``fc``.
* A training BN's batch statistics pass through ``BatchNorm.stats_reduce``
  when it is set (``train.make_train_step(mesh=)`` averages them over the
  ranks there, for the length of one step).
* ``remat`` recomputes each residual block in the backward
  (``torch.utils.checkpoint``); a running-statistics update is applied once,
  on the first of the two forwards.

A temporal arch (``models.get_temporal``: ``tsm_nl_resnet50``) adds two
things to ResNet-50, with ``num_segments`` = T frames a clip, a clip's
frames consecutive rows of the batch:

* TSM's residual shift (``ops.temporal_shift``): every ``Bottleneck``
  shifts 1/8 of its input's channels one frame back and 1/8 one frame
  forward before ``conv1``, in the compute dtype (a copy: exact); the
  shortcut reads the input unshifted;
* ``NonLocal`` after the named blocks (embedded Gaussian, Wang et al. 2018,
  §3.2-3.3): 1x1 convs with bias θ, φ, g to C/2 channels, φ and g
  max-pooled 2x2 over H and W (none over T), softmax over the clip's
  pooled positions of θφᵀ with no 1/√C scale, a 1x1 conv with bias W back
  to C channels, BatchNorm, plus its input. Its leaves are
  ``layer{i}.{j}.nl.{theta,phi,g,W}.{weight,bias}`` and
  ``layer{i}.{j}.nl.bn.*``; its BN trains or freezes with the others. The
  attention is ``nonlocal_attention`` (SDPA at Ci 256, products and a
  softmax at Ci 512, whichever is faster on the card). Each block's
  forward, and its backward through two gradient hooks, is a timed device
  span ``model.nonlocal``.

``random_state_dict`` gives a non-local block the published init (its BN's
gamma 0: the block starts as the identity); ``fold_batchnorm`` folds its BN
into W, conv bias included.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from eov_tpu_torch.models import get_arch, get_temporal
from eov_tpu_torch.ops.temporal_shift import temporal_shift
from eov_tpu_torch.utils import trace

__all__ = ["from_jax_variables", "load_state_dict", "check_state_dict",
           "random_state_dict", "space_to_depth_stem", "s2d_kernel",
           "s2d_frames", "fold_batchnorm",
           "block_names", "nonlocal_attention",
           "Conv", "BiasConv", "BatchNorm", "Bottleneck", "BasicBlock",
           "NonLocal", "ResNet"]

_BN_STATS = ("weight", "bias", "running_mean", "running_var")
_NL_CONVS = ("theta", "phi", "g", "W")


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
    temporal = get_temporal(arch)
    for t in temporal.nonlocal_blocks if temporal else ():
        keys += [f"{t}.nl.{c}.{k}" for c in _NL_CONVS
                 for k in ("weight", "bias")]
        keys += [f"{t}.nl.bn.{k}" for k in _BN_STATS]
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
    temporal = get_temporal(arch)
    for t in temporal.nonlocal_blocks if temporal else ():
        c = sd[f"{t}.conv3.weight"].shape[0]
        for name, (o, i) in zip(_NL_CONVS, 3 * [(c // 2, c)] + [(c, c // 2)]):
            conv(f"{t}.nl.{name}", o, i, 1)
            sd[f"{t}.nl.{name}.bias"] = torch.zeros(o)
        bn(f"{t}.nl.bn", c)
        sd[f"{t}.nl.bn.weight"] = torch.zeros(c)  # the published init
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
        out["conv1.weight"] = s2d_kernel(k).contiguous()
    return out


def s2d_kernel(weight: torch.Tensor) -> torch.Tensor:
    """[O, 3, 7, 7] -> [O, 12, 4, 4] (see ``space_to_depth_stem``);
    differentiable, so the train stem refolds its 7x7 parameter with it."""
    o = weight.shape[0]
    k = F.pad(weight, (1, 0, 1, 0))  # [O, 3, 8, 8]
    # [o, c, a, dy, b, dx] -> [o, dy, dx, c, a, b]
    k = k.reshape(o, 3, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    return k.reshape(o, 12, 4, 4)


def s2d_frames(x_nhwc: torch.Tensor) -> torch.Tensor:
    """NHWC frames [N, H, W, C] (H, W even) -> the space-to-depth input of
    the 4x4 stem conv, NCHW [N, 4C, H/2, W/2] in the (dy, dx, c) channel
    order of ``s2d_kernel``, padded (2, 1) on each spatial axis (F.conv2d
    pads symmetrically only)."""
    b, h, w, c = x_nhwc.shape
    if h % 2 or w % 2:
        raise ValueError(f"stem_s2d needs even frame sizes, got {h}x{w}")
    x = x_nhwc.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, h // 2, w // 2, 4 * c).permute(0, 3, 1, 2)
    return F.pad(x, (2, 1, 2, 1))


def _fold(sd, conv: str, bn: str, eps: float) -> dict:
    # The square root is taken in float64 and rounded once to float32: the
    # correctly rounded f32 root, which XLA computes and the CPU's
    # vectorized f32 sqrt does not always give.
    root = torch.sqrt((sd[f"{bn}.running_var"] + eps).double()).float()
    scale = sd[f"{bn}.weight"] / root
    bias = sd[f"{bn}.bias"] - sd[f"{bn}.running_mean"] * scale
    if f"{conv}.bias" in sd:  # a non-local block's W
        bias = bias + sd[f"{conv}.bias"] * scale
    return {"weight": sd[f"{conv}.weight"] * scale[:, None, None, None],
            "bias": bias}


def fold_batchnorm(sd: Mapping, arch: str = "resnet50",
                   eps: float = 1e-5) -> dict:
    """state_dict -> folded {"conv1": {weight, bias}, "layer1.0": {"conv1":
    {weight, bias}, ..., ["downsample": {weight, bias}], ["nl": {"theta",
    "phi", "g": the convs as they are, "W": folded with its BN}]}, ...} in
    float32."""
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
        if f"{t}.nl.bn.weight" in sd:
            nl = {c: {k: sd[f"{t}.nl.{c}.{k}"] for k in ("weight", "bias")}
                  for c in _NL_CONVS[:3]}
            nl["W"] = _fold(sd, f"{t}.nl.W", f"{t}.nl.bn", eps)
            blk["nl"] = nl
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


class BiasConv(Conv):
    """A 1x1 conv with a bias (a non-local block's): kernel and bias cast to
    ``dtype``, the output rounded to it."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__(cin, cout, 1, dtype=dtype)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


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
        # [2, C] (mean, mean of squares) -> the statistics the forward uses
        # (differentiable); None = the batch's own.
        self.stats_reduce = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training and not self.frozen:
            mean = x.mean(dim=(0, 2, 3))
            sq = (x * x).mean(dim=(0, 2, 3))
            if self.stats_reduce is not None:
                mean, sq = self.stats_reduce(torch.stack([mean, sq])).unbind(0)
            var = torch.clamp_min(sq - mean * mean, 0.0)
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


def nonlocal_attention(theta: torch.Tensor, phi: torch.Tensor,
                       g: torch.Tensor, segments: int) -> torch.Tensor:
    """The embedded-Gaussian attention of a non-local block over each clip:
    ``theta`` [N*T, Ci, H, W], ``phi`` and ``g`` pooled [N*T, Ci, h, w] ->
    softmax(θφᵀ) g, [N*T, Ci, H, W] (channels_last), queries and keys
    every position of the clip's T frames, no 1/√Ci scale.

    Up to Ci 256 (res3) it is ``F.scaled_dot_product_attention``, whose
    fused kernels take head sizes to 256 and keep θφᵀ in f32; above (res4,
    Ci 512) only its memory-efficient kernel is left, and a product of θ
    and φ in f32 (as SDPA's logits), a softmax in f32 and a product in the
    compute dtype take a fraction of its time forward and backward on an
    H100 (PERF.md)."""
    nt, ci, h, w = theta.shape
    n = nt // segments

    def rows(x):  # [N*T, Ci, h, w] -> [N, T*h*w, Ci]
        return x.permute(0, 2, 3, 1).reshape(n, -1, ci)

    q, k, v = rows(theta), rows(phi), rows(g)
    if ci <= 256:
        y = F.scaled_dot_product_attention(q[:, None], k[:, None],
                                           v[:, None], scale=1.0)[:, 0]
    else:
        a = torch.softmax(torch.bmm(q.float(), k.float().transpose(1, 2)),
                          dim=-1)
        y = torch.bmm(a.to(v.dtype), v)
    return y.reshape(nt, h, w, ci).permute(0, 3, 1, 2)


class _BackwardSpan:
    """A timed device span ``model.nonlocal`` around a block's backward:
    opened when the gradient of its output arrives, closed when its input's
    gradient is complete (autograd's thread)."""

    def __init__(self, z: torch.Tensor, out: torch.Tensor):
        self.span = trace.span("model.nonlocal", device=True, timed=True)
        out.register_hook(self.open)
        z.register_hook(self.close)

    def open(self, grad):
        self.span.__enter__()

    def close(self, grad):
        self.span.__exit__(None, None, None)


class NonLocal(nn.Module):
    """Embedded-Gaussian non-local block (module doc) on a block's output
    z [N*T, C, H, W] f32: BN(W(attention)) + z, f32."""

    def __init__(self, c: int, segments: int, dtype, frozen: bool):
        super().__init__()
        self.theta = BiasConv(c, c // 2, dtype)
        self.phi = BiasConv(c, c // 2, dtype)
        self.g = BiasConv(c, c // 2, dtype)
        self.W = BiasConv(c // 2, c, dtype)
        self.bn = BatchNorm(c, frozen)
        self.segments = segments

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        with trace.span("model.nonlocal", device=True, timed=True):
            y = nonlocal_attention(self.theta(z),
                                   F.max_pool2d(self.phi(z), 2, 2),
                                   F.max_pool2d(self.g(z), 2, 2),
                                   self.segments)
            out = self.bn(self.W(y)) + z.float()
        if torch.is_grad_enabled() and out.requires_grad and z.requires_grad:
            _BackwardSpan(z, out)
        return out


class Bottleneck(nn.Module):
    """ResNet v1.5 bottleneck: 1x1 -> 3x3 (stride here) -> 1x1, + shortcut;
    with ``segments`` and ``shift_div`` TSM's shift of conv1's input, with
    ``nonlocal_block`` a ``NonLocal`` on the output (module doc)."""

    def __init__(self, cin: int, filters: int, stride: int, dtype,
                 frozen: bool, segments: int | None = None,
                 shift_div: int | None = None, nonlocal_block: bool = False):
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
        self.segments, self.shift_div = segments, shift_div
        self.nl = (NonLocal(cout, segments, dtype, frozen)
                   if nonlocal_block else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        u = x
        if self.shift_div is not None:
            u = temporal_shift(x.to(self.conv1.dtype), self.segments,
                               x.shape[1] // self.shift_div)
        y = torch.relu(self.bn1(self.conv1(u)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = self.downsample(x) if self.downsample is not None else x.float()
        out = torch.relu(y + r)
        return out if self.nl is None else self.nl(out)


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
                 remat: bool = False, num_segments: int | None = None):
        super().__init__()
        self.arch, self.dtype = arch, dtype
        self.stage_sizes, bottleneck = get_arch(arch)
        self.dropout, self.remat = dropout, remat
        block_cls = Bottleneck if bottleneck else BasicBlock
        temporal = get_temporal(arch)
        if temporal is not None and not num_segments:
            raise ValueError(f"{arch} shifts along a clip's frames: give "
                             "num_segments (T)")
        self.conv1 = Conv(3, width, 7, 2, 3, dtype=dtype)
        self.bn1 = BatchNorm(width)  # the stem BN trains under partial_bn
        cin = width
        for i, n_blocks in enumerate(self.stage_sizes):
            blocks = []
            for j in range(n_blocks):
                kw = {} if temporal is None else {
                    "segments": num_segments,
                    "shift_div": temporal.shift_div,
                    "nonlocal_block": (f"layer{i + 1}.{j}"
                                       in temporal.nonlocal_blocks)}
                blocks.append(block_cls(cin, width * 2 ** i,
                                        2 if i > 0 and j == 0 else 1, dtype,
                                        frozen=partial_bn, **kw))
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
             noise: torch.Tensor | None = None) -> torch.Tensor:
        """Global mean pool (f32) -> dropout -> fc (f32). Dropout keeps a
        pooled feature where ``noise`` (uniform on [0, 1), [N, C]; drawn
        here when None) is below 1 - p."""
        x = x.float().mean(dim=(2, 3))
        if self.fc is None:
            return x
        if self.training and self.dropout > 0:
            if noise is None:
                noise = torch.rand(x.shape, device=x.device)
            keep = noise < 1.0 - self.dropout
            x = torch.where(keep, x / (1.0 - self.dropout),
                            torch.zeros_like(x))
        return self.fc(x)

    def forward(self, x_nhwc: torch.Tensor,
                noise: torch.Tensor | None = None) -> torch.Tensor:
        x = self.stem(x_nhwc)
        for _, _, t in block_names(self.arch):
            x = self.run_block(t, x)
        return self.head(x, noise)
