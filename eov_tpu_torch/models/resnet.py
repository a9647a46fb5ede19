"""ResNet weights for the port: torchvision layout, BN folding, carry-over.

The port's weights are a torchvision-style ResNet ``state_dict`` (OIHW conv
weights, BatchNorm ``weight/bias/running_mean/running_var``) of float32
tensors. This module gets them three ways:

* ``from_jax_variables`` — from the JAX reference's flax ``{params,
  batch_stats}`` tree (as numpy arrays): HWIO -> OIHW, flax names ->
  torchvision names. Every parity test feeds both packages this way.
* ``load_state_dict`` — a torchvision checkpoint (``.pth``) or an ``.npz``
  of the same names, checked against the arch (counterpart of
  ``eov_tpu/tools/port_torch.py:port_resnet_state_dict``).
* ``random_state_dict`` — seeded random weights from a ``torch.Generator``.

``fold_batchnorm`` is the port's own inference BN fold (counterpart of
``eov_tpu/models/resnet.py:fold_batchnorm``): with s = gamma/sqrt(var+eps),
BN(conv(x)) = conv'(x) + b' where W' = W*s and b' = beta - mean*s, computed
in float32 exactly as the reference does.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from eov_tpu_torch.models import get_arch

__all__ = ["from_jax_variables", "load_state_dict", "check_state_dict",
           "random_state_dict", "fold_batchnorm", "block_names"]

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
                      width: int = 64) -> dict:
    """Seeded random weights: conv kernels ~ N(0, 1/fan_in) (LeCun normal,
    the flax default), BatchNorm at its init (gamma 1, beta 0, mean 0,
    var 1). Drawn from a ``torch.Generator`` on the CPU."""
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
    return sd


def _fold(sd, conv: str, bn: str, eps: float) -> dict:
    scale = sd[f"{bn}.weight"] / torch.sqrt(sd[f"{bn}.running_var"] + eps)
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
