"""TSN's sampling and preprocessing (Wang et al. 2016, arXiv:1608.00859),
written out plainly in float32.

* Training: an epoch's order is a permutation from
  ``numpy.random.default_rng(seed + epoch)``, which then draws each clip's K
  segment frames in that order (one random frame per equal segment); the
  step keys are threefry ``split``s of ``key(seed + epoch)``. Each clip's
  key, ``split(step_key, B)[b]``, splits in three: the multiscale crop's
  scale pair, its position among 13 fixed offsets, and a horizontal flip
  (GroupMultiScaleCrop with ``more_fix_crop``; scales 1, .875, .75, .66 of
  the short side, sides within 3 px of the crop snapped to it, pairs at
  most one scale step apart). The crop is resized to the crop size with
  PIL's antialiased bilinear filter. The dropout draw is a ``torch.rand``
  of [B, K, D] from a generator on the device seeded from ``fold_in(key,
  1)``.
* Evaluation: the centre frame of each of K equal segments, a centre crop
  of the short-side-scaled frame.
* Both normalize with ImageNet's mean and std.

The PIL filter weights are those of ``eov_tpu_torch/ops/resize.py:
bilinear_weights`` at commit 1d21111 (a copy).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.frozen import threefry

MEAN = torch.tensor([0.485, 0.456, 0.406])
STD = torch.tensor([0.229, 0.224, 0.225])
SCALES = (1.0, 0.875, 0.75, 0.66)


def train_indices(rng, num_frames: int, k: int) -> np.ndarray:
    avg = num_frames // k
    if avg > 0:
        return np.arange(k) * avg + rng.integers(0, avg, size=k)
    return np.sort(rng.integers(0, num_frames, size=k))


def center_indices(num_frames: int, k: int) -> np.ndarray:
    idx = (num_frames * (2 * np.arange(k) + 1)) // (2 * k)
    return np.minimum(idx, num_frames - 1)


def epoch_plan(n_records: int, frames, k: int, seed: int, epoch: int):
    """[(record index, frame indices)] in the epoch's order."""
    rng = np.random.default_rng(seed + epoch)
    order = rng.permutation(n_records)
    return [(int(i), train_indices(rng, frames[i], k)) for i in order]


def step_keys(seed: int, epoch: int, n: int) -> list[torch.Tensor]:
    key = threefry.key(seed + epoch)
    out = []
    for _ in range(n):
        key, sub = threefry.split(key, 2).unbind(0)
        out.append(sub)
    return out


def bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    w = np.zeros((out_size, in_size), np.float64)
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        xs = np.arange(xmin, xmax, dtype=np.float64)
        ww = np.maximum(0.0, 1.0 - np.abs((xs + 0.5 - center) / filterscale))
        s = ww.sum()
        if s > 0:
            ww /= s
        w[i, xmin:xmax] = ww
    return w


def _resize(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """[..., H, W, C] float32 -> [..., oh, ow, C]."""
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (oh, ow):
        return x
    wh = torch.from_numpy(bilinear_weights(h, oh)).float().to(x.device)
    ww = torch.from_numpy(bilinear_weights(w, ow)).float().to(x.device)
    y = torch.einsum("oh,...hwc->...owc", wh, x)
    return torch.einsum("pw,...owc->...opc", ww, y)


def scale_short_side(x: torch.Tensor, size: int) -> torch.Tensor:
    h, w = x.shape[-3], x.shape[-2]
    if min(h, w) == size:
        return x
    if h <= w:
        return _resize(x, size, int(size * w / h))
    return _resize(x, int(size * h / w), size)


def normalize(x: torch.Tensor) -> torch.Tensor:
    mean, std = MEAN.to(x.device), STD.to(x.device)
    return (x / 255.0 - mean) / std


def _pairs(h: int, w: int, crop: int):
    short = min(h, w)
    sides = []
    for s in SCALES:
        side = min(int(short * s), short)
        sides.append(crop if abs(side - crop) < 3 else side)
    return [(ch, cw) for i, ch in enumerate(sides)
            for j, cw in enumerate(sides) if abs(i - j) <= 1]


def _offsets(max_t: int, max_l: int):
    t, l = max_t // 4, max_l // 4  # noqa: E741 — TSN's naming
    tops = [0, 0, 4 * t, 4 * t, 2 * t, 2 * t, 2 * t, 4 * t, 0,
            t, t, 3 * t, 3 * t]
    lefts = [0, 4 * l, 0, 4 * l, 2 * l, 0, 4 * l, 2 * l, 2 * l,
             l, 3 * l, l, 3 * l]
    return tops, lefts


def train_preprocess(frames_u8: torch.Tensor, step_key: torch.Tensor,
                     batch: int, *, scale: int, crop: int) -> torch.Tensor:
    """uint8 [b, K, H, W, 3], the leading b clips of a batch of ``batch``
    -> normalized float32 [b, K, crop, crop, 3]."""
    x = scale_short_side(frames_u8.float(), scale)
    b, h, w = x.shape[0], x.shape[-3], x.shape[-2]
    pairs = _pairs(h, w, crop)
    keys = threefry.split(step_key, batch)[:b]
    k_scale, k_pos, k_flip = threefry.split(keys, 3).unbind(-2)
    pair = threefry.randint(k_scale, (), 0, len(pairs)).tolist()
    pos = threefry.randint(k_pos, (), 0, 13).tolist()
    flip = threefry.bernoulli(k_flip).tolist()
    out = []
    for i in range(b):
        ch, cw = pairs[pair[i]]
        tops, lefts = _offsets(h - ch, w - cw)
        t, l = tops[pos[i]], lefts[pos[i]]  # noqa: E741
        y = _resize(x[i, :, t:t + ch, l:l + cw], crop, crop)
        out.append(y.flip(-2) if flip[i] else y)
    return normalize(torch.stack(out))


def eval_preprocess(frames_u8: torch.Tensor, *, scale: int,
                    crop: int) -> torch.Tensor:
    """uint8 [..., H, W, 3] -> normalized float32 centre crops."""
    x = scale_short_side(frames_u8.float(), scale)
    h, w = x.shape[-3], x.shape[-2]
    t, l = (h - crop) // 2, (w - crop) // 2  # noqa: E741
    return normalize(x[..., t:t + crop, l:l + crop, :])


def dropout_noise(step_key: torch.Tensor, shape, device) -> torch.Tensor:
    hi, lo = threefry.fold_in(step_key, 1).tolist()
    gen = torch.Generator(device=device)
    gen.manual_seed((hi << 32) | lo)
    return torch.rand(shape, generator=gen, device=device)
