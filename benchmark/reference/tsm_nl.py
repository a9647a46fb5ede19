"""TSM + non-local ResNet-50 in plain float32 PyTorch: weights and forward.

TSM (Lin, Gan, Han 2019, arXiv:1811.08383; the TSM repository's
``ops/temporal_shift.py``, place "blockres", ``shift_div`` 8): in every
bottleneck, the branch's input is shifted along the clip's T frames before
``conv1``, the shortcut reads it unshifted. With f = C // 8 channels each
way, on x viewed as [N, T, C, H, W]:

* ``u[:, t, 0:f] = x[:, t + 1, 0:f]``, zero at t = T - 1;
* ``u[:, t, f:2f] = x[:, t - 1, f:2f]``, zero at t = 0;
* ``u[:, :, 2f:] = x[:, :, 2f:]``.

Non-local blocks (Wang, Girshick, Gupta, He 2018, arXiv:1711.07971,
§3.2-3.3, Table 2b: five blocks, two in res3 and three in res4; the TSM
repository's ``ops/non_local.py:make_non_local``: after ``layer2`` blocks 0
and 2 and ``layer3`` blocks 0, 2 and 4), embedded Gaussian, on a block's
output z with Ci = C / 2:

* θ = conv1×1(z); φ = maxpool_{1×2×2}(conv1×1(z)); g = maxpool_{1×2×2}(
  conv1×1(z)), each conv with a bias; the pool halves H and W, not T;
* A = softmax over the clip's pooled T·(H/2)·(W/2) positions of θφᵀ, with
  no 1/√Ci scale; out = BN(conv1×1(A g) + bias) + z.

Everything else is ``reference/resnet.py``'s ResNet-50 (its helpers, by
import). Under TSM's recipe (``--npb``) every BatchNorm trains on the
batch's statistics; ``batch_stats=False`` uses the running ones.

Departures from the papers: the weights come from the seed
(``make_weights``). The published inits start each residual branch near
the identity: the non-local BN's gamma is 0 (Wang et al. 2018, §4.1), and
TSM finetunes from trained weights. At a random init with every BN on the
batch's statistics a ResNet is chaotic (a bf16 rounding grows tenfold
through each non-local block, float32 and float64 differ by 16% at the
output at 224², measured on a CPU), and no two programs agree. So here every
block's last BN gamma (``bn3``, as Goyal et al. 2017, arXiv:1706.02677,
§5.1, set it to 0) and the non-local BN's gamma are drawn uniform on
[0, 0.2), not 0, so that the comparison sees each branch; and θ's and φ's
kernels are drawn N(0, 1/(fan_in·√Ci)), so that θφᵀ has unit variance at
init, where N(0, 1/fan_in) gives a standard deviation of √Ci (a softmax
that picks one key, and flips it on a rounding).

The planted faults that the cell's limits are set against are knobs here:
``shift`` "off" or "swapped" (the two directions exchanged), ``nonlocal_``
"off" (the blocks removed) or "scaled" (θφᵀ / √Ci), ``batch_stats=False``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import resnet

NL_BLOCKS = ("layer2.0", "layer2.2", "layer3.0", "layer3.2", "layer3.4")
NL_CONVS = ("theta", "phi", "g", "W")


def nonlocal_layout(cfg: dict) -> list[tuple[str, tuple, str]]:
    """The non-local blocks' leaves [(name, shape, init)], after
    ``resnet.layout``'s: init 'conv' (N(0, 1/fan_in)), 'qk' (N(0,
    1/(fan_in·√Ci))), 'zeros', 'ones' or 'gamma' (uniform on [0, 0.2))."""
    cout = {name: c for name, _, _, c, _, _ in resnet.blocks(cfg)}
    rows = []
    for t in cfg["nonlocal_blocks"]:
        c = cout[t]
        for name, (o, i) in zip(NL_CONVS, 3 * [(c // 2, c)] + [(c, c // 2)]):
            rows += [(f"{t}.nl.{name}.weight", (o, i, 1, 1),
                      "qk" if name in ("theta", "phi") else "conv"),
                     (f"{t}.nl.{name}.bias", (o,), "zeros")]
        rows += [(f"{t}.nl.bn.weight", (c,), "gamma"),
                 (f"{t}.nl.bn.bias", (c,), "zeros"),
                 (f"{t}.nl.bn.running_mean", (c,), "zeros"),
                 (f"{t}.nl.bn.running_var", (c,), "ones")]
    return rows


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Seeded float32 weights on ``device``: ``resnet.make_weights``'s (the
    ResNet-50 of ``resnet50_tsn`` at the same seed), then from a second
    generator seeded seed + 1, in one draw each: the non-local kernels
    (module doc), then every ``bn3`` gamma and the non-local BN gammas,
    uniform on [0, 0.2); biases 0, BN at its init otherwise."""
    out = resnet.make_weights(cfg, seed, device)
    rows = nonlocal_layout(cfg)
    gammas = [(n, (len(out[n]),), "gamma") for n in out
              if n.endswith(".bn3.weight")]
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) + 1) % (1 << 63))
    for kinds in (("conv", "qk"), ("gamma",)):
        drawn = [r for r in rows + gammas if r[2] in kinds]
        total = sum(math.prod(s) for _, s, _ in drawn)
        flat = (torch.randn(total, generator=gen, device=device)
                if kinds[0] == "conv" else
                0.2 * torch.rand(total, generator=gen, device=device))
        off = 0
        for name, shape, kind in drawn:
            n = math.prod(shape)
            fan_in = math.prod(shape[1:])
            scale = {"conv": math.sqrt(fan_in),
                     "qk": math.sqrt(fan_in * math.sqrt(shape[0])),
                     "gamma": 1.0}[kind]
            out[name] = (flat[off:off + n] / scale).view(shape)
            off += n
    for name, shape, init in rows:
        if init in ("zeros", "ones"):
            out[name] = (torch.ones if init == "ones" else torch.zeros)(
                shape, device=device)
    return out


def shift(x: torch.Tensor, t: int, fold: int, mode: str = "on"):
    """TSM's shift of [N*T, C, H, W] (module doc); ``mode`` 'off' or
    'swapped' plants a fault."""
    if mode == "off":
        return x
    v = x.reshape(x.shape[0] // t, t, *x.shape[1:])
    out = torch.zeros_like(v)
    nxt, prv = slice(0, fold), slice(fold, 2 * fold)
    if mode == "swapped":
        nxt, prv = prv, nxt
    out[:, :-1, nxt] = v[:, 1:, nxt]
    out[:, 1:, prv] = v[:, :-1, prv]
    out[:, :, 2 * fold:] = v[:, :, 2 * fold:]
    return out.reshape(x.shape)


def _bias_conv(p, name, x, quant):
    w = p[f"{name}.weight"]
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, p[f"{name}.bias"])


def nonlocal_block(p, name: str, z: torch.Tensor, t: int, *,
                   batch_stats: bool = True, mode: str = "on", quant=None):
    """The embedded-Gaussian block on z [N*T, C, H, W] (module doc)."""
    if mode == "off":
        return z
    nt, c, h, w = z.shape
    n, ci = nt // t, c // 2

    def rows(y):  # [N*T, Ci, h, w] -> [N, T*h*w, Ci]
        return y.reshape(n, t, ci, *y.shape[2:]).permute(
            0, 1, 3, 4, 2).reshape(n, -1, ci)

    q = rows(_bias_conv(p, f"{name}.nl.theta", z, quant))
    k = rows(F.max_pool2d(_bias_conv(p, f"{name}.nl.phi", z, quant), 2, 2))
    v = rows(F.max_pool2d(_bias_conv(p, f"{name}.nl.g", z, quant), 2, 2))
    if quant is not None:
        q, k, v = quant(q), quant(k), quant(v)
    s = q @ k.transpose(1, 2)
    if mode == "scaled":
        s = s / math.sqrt(ci)
    a = torch.softmax(s, dim=-1)
    if quant is not None:
        a = quant(a)
    y = (a @ v).reshape(n, t, h, w, ci).permute(0, 1, 4, 2, 3).reshape(
        nt, ci, h, w)
    y = _bias_conv(p, f"{name}.nl.W", y, quant)
    return resnet._bn(p, f"{name}.nl.bn", y, batch_stats) + z


def _block(p, cfg, spec, x, *, batch_stats, shift_mode, nl_mode, quant):
    name, _, _, _, s, proj = spec
    t = cfg["train_segments"]
    u = shift(x, t, x.shape[1] // cfg["shift_div"], shift_mode)
    y = torch.relu(resnet._bn(p, f"{name}.bn1", resnet._conv(
        p, f"{name}.conv1", u, quant=quant), batch_stats))
    y = torch.relu(resnet._bn(p, f"{name}.bn2", resnet._conv(
        p, f"{name}.conv2", y, s, 1, quant=quant), batch_stats))
    y = resnet._bn(p, f"{name}.bn3", resnet._conv(
        p, f"{name}.conv3", y, quant=quant), batch_stats)
    r = x
    if proj:
        r = resnet._bn(p, f"{name}.downsample.1", resnet._conv(
            p, f"{name}.downsample.0", x, s, quant=quant), batch_stats)
    out = torch.relu(y + r)
    if name in cfg["nonlocal_blocks"]:
        out = nonlocal_block(p, name, out, t, batch_stats=batch_stats,
                             mode=nl_mode, quant=quant)
    return out


def forward(p: dict, cfg: dict, x_nhwc: torch.Tensor, *,
            batch_stats: bool = True, noise=None, dropout: float = 0.0,
            head: bool = True, quant=None, shift_mode: str = "on",
            nl_mode: str = "on", segments: int | None = None):
    """Images [N*T, H, W, 3] (normalized, float32; a clip's T =
    ``segments`` frames consecutive, ``train_segments`` by default) ->
    logits [N*T, classes] (``head``) or pooled features [N*T, D]."""
    if segments is not None:
        cfg = dict(cfg, train_segments=segments)
    x = x_nhwc.permute(0, 3, 1, 2)
    x = resnet._conv(p, "conv1", x, 2, 3, quant=quant)
    x = torch.relu(resnet._bn(p, "bn1", x, batch_stats))
    x = F.max_pool2d(x, 3, 2, 1)
    for spec in resnet.blocks(cfg):
        x = _block(p, cfg, spec, x, batch_stats=batch_stats,
                   shift_mode=shift_mode, nl_mode=nl_mode, quant=quant)
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


def features(p: dict, cfg: dict, frames_u8: torch.Tensor, *, k: int,
             scale: int, crop: int) -> torch.Tensor:
    """uint8 clips [B, K, H, W, 3] (centre frames) -> clip features [B, D]:
    TSN's eval preprocessing, every BN on its running statistics, the mean
    over the K segments (T = K)."""
    from benchmark.reference import tsn

    resnet.no_tf32()
    x = tsn.eval_preprocess(frames_u8, scale=scale, crop=crop)
    b = x.shape[0]
    f = forward(p, cfg, x.reshape(b * k, *x.shape[2:]), batch_stats=False,
                head=False, segments=k)
    return f.reshape(b, k, -1).mean(dim=1)
