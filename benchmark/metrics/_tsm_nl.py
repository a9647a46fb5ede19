"""The work of ``tsm_nl_resnet50``, counted from the configuration's shapes
whatever implements it: the forward's FLOPs a clip (2 per
multiply-accumulate: ``frozen.flops``'s ResNet-50 convs and fc on each of
the T frames, then each non-local block's four 1x1 convs and its two
attention products), and the bytes the temporal shift must move.

A non-local block on [T, H, W, C] with Ci = C / 2: θ, φ and g are 1x1 convs
C -> Ci over the T·H·W positions, W one Ci -> C; φ and g are pooled to
T·(H/2)·(W/2) keys; θφᵀ and A·g take L·S·Ci multiply-accumulates each, L =
T·H·W queries, S the keys. At 224², T 8: 8.33 G a res3 block, 3.92 G a
res4 one, 28.4 G for the five.

The shift reads each bottleneck's input once and writes its shifted copy
once, forward and adjoint alike (16 blocks, the compute dtype).
"""

from __future__ import annotations

from benchmark.frozen import flops

_BYTES = {"bfloat16": 2, "float32": 4}


def _blocks(cfg: dict):
    """[(name, input side, cin, output side, cout)] of the bottlenecks at
    the configuration's crop."""
    side, cin, out = cfg["crop_size"] // 4, cfg["width"], []
    for i, n in enumerate(cfg["stage_sizes"]):
        f = cfg["width"] * 2 ** i
        for j in range(n):
            o = side // 2 if i > 0 and j == 0 else side
            out.append((f"layer{i + 1}.{j}", side, cin, o, 4 * f))
            side, cin = o, 4 * f
    return out


def nonlocal_macs(t: int, side: int, c: int) -> int:
    """Multiply-accumulates of one block on a clip's [T, side, side, C]."""
    ci, q = c // 2, t * side * side
    keys = t * (side // 2) ** 2
    return 4 * q * c * ci + 2 * q * keys * ci


def forward_flops_per_clip(cfg: dict) -> int:
    t = cfg["train_segments"]
    per_image = flops.resnet_forward_flops(
        cfg["stage_sizes"], True, (cfg["crop_size"], cfg["crop_size"]),
        num_classes=cfg["num_classes"], width=cfg["width"])
    nl = sum(2 * nonlocal_macs(t, side, c)
             for name, _, _, side, c in _blocks(cfg)
             if name in cfg["nonlocal_blocks"])
    return t * per_image + nl


def shift_bytes_per_image(cfg: dict) -> int:
    """Forward and adjoint: each reads and writes every block input."""
    e = _BYTES[cfg["compute_dtype"]]
    return sum(2 * 2 * side * side * cin * e
               for _, side, cin, _, _ in _blocks(cfg))
