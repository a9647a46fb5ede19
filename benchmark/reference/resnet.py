"""ResNet v1.5 (He et al. 2016, arXiv:1512.03385, Table 1; torchvision's
stride on the 3x3) in plain float32 PyTorch, with TSN's training rules.

Parameters are a flat dict under torchvision's names. ``forward`` runs the
network on NHWC images:

* the stem: 7x7/2 conv (pad 3), BN, ReLU, 3x3/2 max-pool (pad 1);
* bottleneck blocks (1x1, 3x3 with the stride, 1x1, x4 expansion) or basic
  blocks (3x3 with the stride, 3x3), a 1x1 projection with BN where the
  shape changes, ReLU after the residual add;
* global mean pool, then, with a head, dropout and the fc layer.

BatchNorm is ``(x - mean) * rsqrt(var + 1e-5) * gamma + beta``. Under TSN's
partial BN only the stem's BN trains, on the batch's statistics (the biased
variance E[x²] - E[x]²); every other BN, and every BN outside training,
uses its running statistics. Dropout keeps a pooled feature where the given
uniform draw is below 1 - p and scales it by 1 / (1 - p).

``quant`` (the control) rounds each conv's and the fc's input and weight
through a lower precision before the float32 product.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-5


def no_tf32() -> None:
    """Full float32 products on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def blocks(cfg: dict):
    """[(name, cin, filters, cout, stride, projection)] in forward order."""
    width = cfg["width"]
    bottleneck = cfg["block"] == "bottleneck"
    out, cin = [], width
    for i, n in enumerate(cfg["stage_sizes"]):
        f = width * 2 ** i
        cout = 4 * f if bottleneck else f
        for j in range(n):
            s = 2 if i > 0 and j == 0 else 1
            out.append((f"layer{i + 1}.{j}", cin, f, cout, s,
                        cin != cout or s != 1))
            cin = cout
    return out


def layout(cfg: dict) -> list[tuple[str, tuple, str]]:
    """[(name, shape, init)]: init is 'conv' (N(0, 1/fan_in)), 'fc',
    'ones' or 'zeros'."""
    rows = []

    def conv(name, o, i, k):
        rows.append((f"{name}.weight", (o, i, k, k), "conv"))

    def bn(name, c):
        rows.extend([(f"{name}.weight", (c,), "ones"),
                     (f"{name}.bias", (c,), "zeros"),
                     (f"{name}.running_mean", (c,), "zeros"),
                     (f"{name}.running_var", (c,), "ones")])

    width = cfg["width"]
    conv("conv1", width, 3, 7)
    bn("bn1", width)
    bottleneck = cfg["block"] == "bottleneck"
    for name, cin, f, cout, _, proj in blocks(cfg):
        convs = ([(f, cin, 1), (f, f, 3), (cout, f, 1)] if bottleneck
                 else [(f, cin, 3), (f, f, 3)])
        for c, (o, i, k) in enumerate(convs, start=1):
            conv(f"{name}.conv{c}", o, i, k)
            bn(f"{name}.bn{c}", o)
        if proj:
            conv(f"{name}.downsample.0", cout, cin, 1)
            bn(f"{name}.downsample.1", cout)
    if cfg.get("num_classes"):
        d = blocks(cfg)[-1][3]
        rows += [("fc.weight", (cfg["num_classes"], d), "fc"),
                 ("fc.bias", (cfg["num_classes"],), "zeros")]
    return rows


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Seeded float32 weights on ``device``, drawn by one generator on the
    device in one call: conv and fc kernels N(0, 1/fan_in), BN at its init
    (gamma 1, beta 0, mean 0, var 1), fc bias 0."""
    rows = layout(cfg)
    drawn = [r for r in rows if r[2] in ("conv", "fc")]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, init in rows:
        if init in ("conv", "fc"):
            n = math.prod(shape)
            fan_in = math.prod(shape[1:])
            out[name] = (flat[off:off + n] / math.sqrt(fan_in)).view(shape)
            off += n
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def _bn(p, name, x, batch_stats: bool):
    if batch_stats:
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    mul = torch.rsqrt(var + EPS) * p[f"{name}.weight"]
    return ((x - mean[:, None, None]) * mul[:, None, None]
            + p[f"{name}.bias"][:, None, None])


def _conv(p, name, x, stride=1, padding=0, quant=None):
    w = p[f"{name}.weight"]
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, stride=stride, padding=padding)


def _block(p, cfg, spec, x, quant):
    name, _, _, _, s, proj = spec
    if cfg["block"] == "bottleneck":
        y = torch.relu(_bn(p, f"{name}.bn1",
                           _conv(p, f"{name}.conv1", x, quant=quant), False))
        y = torch.relu(_bn(p, f"{name}.bn2", _conv(
            p, f"{name}.conv2", y, s, 1, quant=quant), False))
        y = _bn(p, f"{name}.bn3", _conv(p, f"{name}.conv3", y, quant=quant),
                False)
    else:
        y = torch.relu(_bn(p, f"{name}.bn1", _conv(
            p, f"{name}.conv1", x, s, 1, quant=quant), False))
        y = _bn(p, f"{name}.bn2", _conv(p, f"{name}.conv2", y, 1, 1,
                                        quant=quant), False)
    r = x
    if proj:
        r = _bn(p, f"{name}.downsample.1", _conv(
            p, f"{name}.downsample.0", x, s, quant=quant), False)
    return torch.relu(y + r)


def forward(p: dict, cfg: dict, x_nhwc: torch.Tensor, *,
            train_stem_bn: bool = False, noise=None, dropout: float = 0.0,
            head: bool = True, quant=None, remat: bool = False):
    """Images [N, H, W, 3] (normalized, float32) -> logits [N, classes]
    (``head``) or pooled features [N, D]."""
    x = x_nhwc.permute(0, 3, 1, 2)
    x = _conv(p, "conv1", x, 2, 3, quant=quant)
    x = torch.relu(_bn(p, "bn1", x, train_stem_bn))
    x = F.max_pool2d(x, 3, 2, 1)
    for spec in blocks(cfg):
        if remat and torch.is_grad_enabled():
            x = checkpoint(_block, p, cfg, spec, x, quant, use_reentrant=False)
        else:
            x = _block(p, cfg, spec, x, quant)
    x = x.mean(dim=(2, 3))
    if not head:
        return x
    if noise is not None and dropout > 0:
        x = torch.where(noise < 1.0 - dropout, x / (1.0 - dropout),
                        torch.zeros_like(x))
    w = p["fc.weight"]
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.linear(x, w, p["fc.bias"])


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """The control's precision: float8 e4m3 with one scale per tensor (its
    largest magnitude at 448), rounded and scaled back; the gradient passes
    straight through."""
    scale = t.detach().abs().amax().clamp_min(1e-12) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())
