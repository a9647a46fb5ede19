"""Post-training int8 inference forward of the folded ResNet.

Counterpart of ``eov_tpu/models/quant_infer.py``. It quantizes the folded
inference network (``models.resnet.fold_batchnorm`` output):

* weights: per output channel, symmetric int8,
  ``w_scale = max(max|k| / 127, 1e-12)``,
  ``kernel_q = clip(round(k / w_scale), -127, 127)``;
* activations: per conv site, symmetric int8,
  ``a_scale = max(act_max / 127, 1e-12)``, where ``act_max`` is ``max|x|``
  at the conv's input over calibration clips (``calibrate_act_max``: an
  f32 forward, TF32 off on the GPU);
* each conv (``qconv``): ``clip(round(x_f32 * (1/a)), -127, 127)`` -> int8,
  an int8 x int8 product summed exactly in int32, then
  ``T(acc_f32 * (a * w_scale))`` in the compute dtype T.

Bias, ReLU, the ``-inf``-padded maxpool, the residual adds (in T) and the
global pool stay float, as in the reference's ``_walk``.

The ``act_max`` dict is keyed by the reference's conv site names
(``"conv1"``, ``"layer1_0/conv1"``, ``"layer2_0/downsample_conv"``, ...),
because stores record it in their manifests (``quant_calib``) and both
packages read those; ``conv_sites`` maps them to the port's names.

Every int8 conv outside a fused stage is an im2col over the requantized
input and ``torch._int_mm`` (the reference leaves these to XLA, not to a
Pallas kernel). With ``fused_stages=(1,)`` (what ``"auto"`` resolves to on
bottleneck archs, as the port's bf16 rule does on every device) stage 1
runs through ``ops.bottleneck_int8.fused_bottleneck_stack_int8``, kernel 7
on the GPU; its arithmetic is the walk's, so both programs give the same
features. ``fused_stages=()`` runs the pure int8 walk.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eov_tpu_torch.data.fixtures import synthetic_clip
from eov_tpu_torch.models import get_arch
from eov_tpu_torch.models.resnet import block_names
from eov_tpu_torch.ops.bottleneck_int8 import (fused_bottleneck_stack_int8,
                                               int_mm,
                                               pack_bottleneck_params_int8,
                                               prepare_site, quantize_act)

__all__ = ["conv_sites", "calibrate_act_max", "quantize_conv",
           "quantize_variables", "qconv", "qblock", "QuantResNet",
           "quant_feature_apply", "synthetic_calib_frames",
           "calibrate_and_quantize", "resolve_quant_fused_stages"]


def conv_sites(arch: str) -> dict[str, tuple[str, str | None]]:
    """The reference's conv site names, in forward order, mapped to the
    port's folded names: ``{"conv1": ("conv1", None), "layer1_0/conv1":
    ("layer1.0", "conv1"), "layer1_0/downsample_conv": ("layer1.0",
    "downsample"), ...}``. Read in reverse, it names a port conv's site."""
    stage_sizes, bottleneck = get_arch(arch)
    sites = {"conv1": ("conv1", None)}
    for i, j, t in block_names(arch):
        ref = t.replace(".", "_")
        for c in range(1, (3 if bottleneck else 2) + 1):
            sites[f"{ref}/conv{c}"] = (t, f"conv{c}")
        if j == 0 and (i > 0 or bottleneck):
            sites[f"{ref}/downsample_conv"] = (t, "downsample")
    return sites


def _walk(x: torch.Tensor, conv: Callable, bias: Callable, *, arch: str,
          dtype, stage_override: Callable | None = None) -> torch.Tensor:
    """The folded ResNet forward over NHWC ``x`` with every conv routed
    through ``conv(name, x, stride, pad)`` (pre-bias output in ``dtype``);
    ``bias(name)`` is the folded bias in ``dtype``. Names are the port's
    (``"conv1"``, ``"layer1.0.conv2"``, ``"layer1.0.downsample"``).

    ``stage_override(i, x)`` may return the whole output of stage i
    (the fused int8 stack) or None to walk its blocks.
    """
    stage_sizes, bottleneck = get_arch(arch)
    lead = x.shape[:-3]
    x = x.reshape(-1, *x.shape[-3:]).to(dtype)
    x = torch.relu(conv("conv1", x, 2, 3) + bias("conv1"))
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    for i, n_blocks in enumerate(stage_sizes):
        if stage_override is not None:
            y = stage_override(i, x)
            if y is not None:
                x = y
                continue
        for j in range(n_blocks):
            t = f"layer{i + 1}.{j}"

            def cb(c, inp, s, pad, t=t):
                return conv(f"{t}.{c}", inp, s, pad) + bias(f"{t}.{c}")

            x = _block(x, cb, 2 if (i > 0 and j == 0) else 1, bottleneck,
                       bias(f"{t}.downsample") is not None)
    x = x.mean(dim=(1, 2), dtype=torch.float32).to(dtype).float()
    return x.reshape(*lead, -1)


def _block(x: torch.Tensor, cb: Callable, stride: int, bottleneck: bool,
           has_ds: bool) -> torch.Tensor:
    """One residual block; ``cb(conv, x, stride, pad)`` is a conv plus its
    bias. The residual add and the ReLUs run in x's dtype."""
    if bottleneck:
        y = torch.relu(cb("conv1", x, 1, 0))
        y = torch.relu(cb("conv2", y, stride, 1))
        y = cb("conv3", y, 1, 0)
    else:
        y = torch.relu(cb("conv1", x, stride, 1))
        y = cb("conv2", y, 1, 1)
    r = cb("downsample", x, stride, 0) if has_ds else x
    return torch.relu(y + r)


def _folded_conv(folded: Mapping, name: str):
    if name == "conv1":
        return folded["conv1"]
    t, _, c = name.rpartition(".")
    return folded[t].get(c)


@torch.no_grad()
def calibrate_act_max(folded: Mapping, frames: torch.Tensor, *,
                      arch: str = "resnet50") -> dict[str, torch.Tensor]:
    """f32 folded forward over PREPROCESSED ``frames`` [..., H, W, 3]
    recording ``max|x|`` at every conv input; ``{site: f32 scalar}`` under
    the reference's site names, on the frames' device. TF32 is off on the
    GPU (the reference's f32 convs are full f32). Several calibration
    batches: take the elementwise max of the dicts."""
    if frames.is_cuda:
        from eov_tpu_torch.models.folded_infer import use_full_f32
        use_full_f32()
    dev = frames.device
    to_site = {f"{t}.{c}" if c else t: site
               for site, (t, c) in conv_sites(arch).items()}
    taps: dict[str, torch.Tensor] = {}

    def conv(name, x, stride, pad):
        taps[to_site[name]] = x.float().abs().amax()
        wt = _folded_conv(folded, name)["weight"].to(dev, torch.float32)
        y = F.conv2d(x.permute(0, 3, 1, 2), wt, stride=stride, padding=pad)
        return y.permute(0, 2, 3, 1)

    def bias(name):
        c = _folded_conv(folded, name)
        return None if c is None else c["bias"].to(dev, torch.float32)

    _walk(frames.float(), conv, bias, arch=arch, dtype=torch.float32)
    return taps


# XLA compiles the reference's division by the constant 127 as a product
# with its f32 reciprocal; the port forms the same product so the scales
# are equal bit for bit.
_INV_127 = float(np.float32(1) / np.float32(127))


def quantize_conv(conv: Mapping[str, torch.Tensor], act_max) -> dict:
    """One folded conv ``{weight OIHW, bias}`` + its calibrated ``max|x|``
    -> ``{kernel_q int8 OIHW, w_scale f32 [O], a_scale f32 scalar, bias}``,
    computed in f32 as the reference's compiled program computes it."""
    k = conv["weight"].to(torch.float32)
    w_scale = torch.clamp_min(k.abs().amax(dim=(1, 2, 3)) * _INV_127, 1e-12)
    kq = torch.clamp(torch.round(k / w_scale[:, None, None, None]), -127,
                     127).to(torch.int8)
    amax = torch.as_tensor(act_max, dtype=torch.float32).to(k.device)
    a_scale = torch.clamp_min(amax * _INV_127, 1e-12)
    return {"kernel_q": kq, "w_scale": w_scale, "a_scale": a_scale,
            "bias": conv["bias"].to(torch.float32)}


def quantize_variables(folded: Mapping, act_max: Mapping,
                       arch: str = "resnet50") -> dict:
    """Folded weights + calibrated activation maxima (reference site names)
    -> the quantized tree, shaped as ``folded``: every conv becomes
    ``quantize_conv``'s dict. A site missing from ``act_max`` raises
    KeyError naming it."""
    out: dict = {}
    for site, (t, c) in conv_sites(arch).items():
        if site not in act_max:
            raise KeyError(site)
        if c is None:
            out[t] = quantize_conv(folded[t], act_max[site])
        else:
            out.setdefault(t, {})[c] = quantize_conv(folded[t][c],
                                                     act_max[site])
    return out


def qconv(x: torch.Tensor, site: Mapping, stride: int, pad: int,
          dtype) -> torch.Tensor:
    """The int8 conv of ``prepare_site`` params on NHWC ``x``: requantize,
    im2col, int8 x int8 -> int32 (``int_mm``), dequantize to ``dtype``."""
    xq = quantize_act(x, site["inv_a"])
    n, h, w, c = xq.shape
    k = site["k"]
    if k == 1:
        if stride > 1:
            xq = xq[:, ::stride, ::stride]
        ho, wo = xq.shape[1], xq.shape[2]
        a = xq.reshape(-1, c)
    else:
        xp = F.pad(xq, (0, 0, pad, pad, pad, pad))
        ho = (h + 2 * pad - k) // stride + 1
        wo = (w + 2 * pad - k) // stride + 1
        cols = [xp[:, ky:ky + stride * (ho - 1) + 1:stride,
                   kx:kx + stride * (wo - 1) + 1:stride, :]
                for ky in range(k) for kx in range(k)]
        a = torch.stack(cols, dim=3).reshape(n * ho * wo, k * k * c)
    acc = int_mm(a, site["wq"])
    return (acc.float() * site["scale"]).to(dtype).reshape(n, ho, wo, -1)


def qblock(x: torch.Tensor, sites: Mapping[str, Mapping], stride: int,
           dtype) -> torch.Tensor:
    """One residual block of ``prepare_site`` params (``conv1``..``conv3``
    for a bottleneck, ``conv1``..``conv2`` for a basic block, optionally
    ``downsample``) on NHWC ``x``, walked conv by conv."""
    def cb(c, inp, s, pad):
        return qconv(inp, sites[c], s, pad, dtype) + sites[c]["bias"].to(dtype)

    return _block(x, cb, stride, "conv3" in sites, "downsample" in sites)


def resolve_quant_fused_stages(fused_stages, *, arch: str) -> tuple:
    """The int8 forward's fused stages: ``"auto"`` -> ``(1,)`` on bottleneck
    archs, ``()`` on basic ones; explicit ``(1,)`` or ``()`` honored;
    anything else refused (the reference's refusals)."""
    bottleneck = get_arch(arch)[1]
    if fused_stages == "auto":
        return (1,) if bottleneck else ()
    stages = tuple(int(s) for s in (fused_stages or ()))
    if stages and stages != (1,):
        raise ValueError(f"int8 fused_stages supports (1,) only, got "
                         f"{stages!r}")
    if stages and not bottleneck:
        raise ValueError("int8 fused stage-1 is implemented for bottleneck "
                         f"archs only (arch={arch!r})")
    return stages


class QuantResNet(nn.Module):
    """The int8 inference network of a quantized tree
    (``quantize_variables`` output). Conv sites are kept as ``prepare_site``
    buffers; with stage 1 fused, its blocks are kept packed for kernel 7."""

    def __init__(self, qvars: Mapping, *, arch: str = "resnet50",
                 dtype=torch.bfloat16, fused_stages="auto"):
        super().__init__()
        self.arch, self.dtype = arch, dtype
        self.stage_sizes, self.bottleneck = get_arch(arch)
        self.fused_stages = resolve_quant_fused_stages(fused_stages,
                                                       arch=arch)
        self._sites: dict[str, dict] = {}
        self._packs: list[dict[str, str]] = []
        self._add_site("conv1", qvars["conv1"])
        for i, _, t in block_names(arch):
            if i == 0 and 1 in self.fused_stages:
                names = {}
                for k, v in pack_bottleneck_params_int8(qvars[t]).items():
                    names[k] = f"pack_{t.replace('.', '_')}_{k}"
                    self.register_buffer(names[k], v)
                self._packs.append(names)
            else:
                for c, conv in qvars[t].items():
                    self._add_site(f"{t}.{c}", conv)

    def _add_site(self, name: str, qconv_params: Mapping) -> None:
        key = name.replace(".", "_")
        site = prepare_site(qconv_params)
        names = {}
        for k in ("wq", "scale", "inv_a", "bias"):
            names[k] = f"{key}_{k}"
            self.register_buffer(names[k], site[k])
        self._sites[name] = {"names": names, "k": site["k"]}

    def site(self, name: str) -> dict | None:
        entry = self._sites.get(name)
        if entry is None:
            return None
        out = {k: getattr(self, v) for k, v in entry["names"].items()}
        out["k"] = entry["k"]
        return out

    def _stage1(self, i: int, x: torch.Tensor):
        if i != 0 or not self._packs:
            return None
        n, h, w, c = x.shape
        blocks = [{k: getattr(self, v) for k, v in names.items()}
                  for names in self._packs]
        y = fused_bottleneck_stack_int8(x.reshape(n, h * w, c).contiguous(),
                                        blocks, h=h, w=w)
        return y.reshape(n, h, w, -1)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """frames [..., H, W, 3] (preprocessed) -> features [..., D] f32."""
        dt = self.dtype

        def conv(name, x, stride, pad):
            return qconv(x, self.site(name), stride, pad, dt)

        def bias(name):
            s = self.site(name)
            return None if s is None else s["bias"].to(dt)

        return _walk(frames, conv, bias, arch=self.arch, dtype=dt,
                     stage_override=self._stage1)


def quant_feature_apply(qvars: Mapping, frames: torch.Tensor, *,
                        arch: str = "resnet50", dtype=torch.bfloat16,
                        fused_stages=()) -> torch.Tensor:
    """Functional form: frames [..., H, W, 3] -> features [..., D] on the
    frames' device through the int8 forward."""
    net = QuantResNet(qvars, arch=arch, dtype=dtype,
                      fused_stages=fused_stages).to(frames.device)
    return net(frames)


def synthetic_calib_frames(n_clips: int, num_segments: int, height: int,
                           width: int) -> np.ndarray:
    """uint8 [n_clips, K, H, W, 3] deterministic calibration clips (the
    fixtures' 6 procedural classes, cycled), as the reference makes them."""
    return np.stack([synthetic_clip(i % 6, i // 6, num_segments, height,
                                    width) for i in range(n_clips)])


def calibrate_and_quantize(folded: Mapping, calib_frames: torch.Tensor, *,
                           arch: str = "resnet50") -> dict:
    """Calibrate on PREPROCESSED ``calib_frames`` and quantize in one go."""
    return quantize_variables(
        folded, calibrate_act_max(folded, calib_frames, arch=arch), arch)
