"""Preprocess: uint8 frames -> ImageNet-normalized NHWC network input.

Counterpart of ``eov_tpu/ops/preprocess.py``:

* ``preprocess_eval`` — the TSN test-time chain: short-side resize ->
  center crop -> /255 -> normalize. The fused crop+normalize kernel for
  storage-normalized frames is ``ops/crop_normalize.py``; this function is
  its semantics reference.
* ``preprocess_train`` — random crop + random horizontal flip;
  ``preprocess_train_multiscale`` — TSN's GroupMultiScaleCrop (10 crop-size
  pairs x 13 fixed positions, resized to the crop) + random flip, the train
  step's default. Both take a BATCH of clips ``[B, K, H, W, 3]`` and one
  threefry key per clip ``[B, 2]`` (``prng.split(step_key, B)``), and draw
  each clip's geometry exactly as the reference's ``jax.vmap`` over its
  per-clip function does (``prng.randint``/``bernoulli`` are bit-exact), so
  the same keys give the same crops. One draw applies to all K frames.
  The draws (threefry on the host) run in a ``train.keys`` span, after the
  resize is launched, so the device resizes while the host draws.

The multiscale crop is the reference's gathered-weights form: the drawn
pair's PIL resize weights, embedded in fixed-size planes and rolled by the
drawn offset, make the crop and the resize two f32 products (TF32 off on a
GPU). The reference keeps a ``lax.switch`` variant only as its own oracle
against a ``vmap`` artefact; a batch written out has no such artefact, so
the port has no switch variant.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from eov_tpu_torch import prng
from eov_tpu_torch.ops import resize as resize_ops
from eov_tpu_torch.utils import trace

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "NORM_SCALE", "NORM_BIAS",
           "normalize", "center_crop", "preprocess_eval", "preprocess_train",
           "preprocess_train_multiscale"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# Folded affine, computed in float32 exactly as the reference computes it:
# (x/255 - mean) / std == x * (1/(255*std)) - mean/std.
NORM_SCALE = (1.0 / (255.0 * IMAGENET_STD)).astype(np.float32)
NORM_BIAS = (IMAGENET_MEAN / IMAGENET_STD).astype(np.float32)


def normalize(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[0, 255] float -> ImageNet-normalized, channels-last, in ``dtype``.

    The affine is rounded once (as a fused multiply-add would round it),
    which is how XLA compiles the reference's ``x * scale - bias``; it is
    evaluated in float64 and cast, so both devices give the same bits.
    """
    scale = torch.from_numpy(NORM_SCALE).to(x.device, dtype).double()
    bias = torch.from_numpy(NORM_BIAS).to(x.device, dtype).double()
    return (x.to(dtype).double() * scale - bias).to(dtype)


def center_crop(x: torch.Tensor, crop: int) -> torch.Tensor:
    """Center crop of [..., H, W, C] to [..., crop, crop, C] (a view)."""
    h, w = x.shape[-3], x.shape[-2]
    top, left = (h - crop) // 2, (w - crop) // 2
    return x[..., top:top + crop, left:left + crop, :]


def preprocess_eval(frames_u8: torch.Tensor, *, scale_size: int = 256,
                    crop_size: int = 224,
                    dtype=torch.float32) -> torch.Tensor:
    """uint8 [..., H, W, 3] -> normalized [..., crop, crop, 3] in ``dtype``."""
    x = frames_u8.to(dtype)
    x = resize_ops.resize_short_side(x, scale_size)
    x = center_crop(x, crop_size)
    return normalize(x, dtype)


def _flip(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Flip clip b of x [B, K, H, W, C] along W where flip[b]."""
    f = flip.to(x.device).reshape(-1, *([1] * (x.dim() - 1)))
    return torch.where(f, x.flip(-2), x)


def preprocess_train(keys: torch.Tensor, frames_u8: torch.Tensor, *,
                     scale_size: int = 256, crop_size: int = 224,
                     dtype=torch.float32) -> torch.Tensor:
    """Random crop + random horizontal flip per clip: uint8 [B, K, H, W, 3]
    with keys [B, 2] -> normalized [B, K, crop, crop, 3] in ``dtype``."""
    x = resize_ops.resize_short_side(frames_u8.to(torch.float32), scale_size)
    h, w = x.shape[-3], x.shape[-2]
    with trace.span("train.keys"):
        k_top, k_left, k_flip = prng.split(keys, 3).unbind(-2)
        tops = prng.randint(k_top, (), 0, h - crop_size + 1).tolist()
        lefts = prng.randint(k_left, (), 0, w - crop_size + 1).tolist()
    x = torch.stack([x[b, :, t:t + crop_size, l:l + crop_size]
                     for b, (t, l) in enumerate(zip(tops, lefts))])
    return normalize(_flip(x, prng.bernoulli(k_flip)), dtype)


# TSN GroupMultiScaleCrop scale set (fractions of the short side).
_MS_SCALES = (1.0, 0.875, 0.75, 0.66)
_MS_MAX_DISTORT = 1  # one step of H/W aspect distortion between scale idxs


def _ms_crop_pairs(h: int, w: int, crop_size: int) -> list[tuple[int, int]]:
    """The TSN (crop_h, crop_w) candidates for an HxW image: sides are
    scale * short side, a side within 3 px of the crop snaps to it, and the
    pair combines scale indices at most one step apart (10 pairs)."""
    short = min(h, w)
    sides = []
    for s in _MS_SCALES:
        side = min(int(short * s), short)
        sides.append(crop_size if abs(side - crop_size) < 3 else side)
    return [(ch, cw) for i, ch in enumerate(sides)
            for j, cw in enumerate(sides) if abs(i - j) <= _MS_MAX_DISTORT]


def _ms_fix_offsets(max_t: int, max_l: int) -> tuple[list[int], list[int]]:
    """TSN fill_fix_offset with more_fix_crop: the 13 canonical positions."""
    t, l = max_t // 4, max_l // 4  # noqa: E741 — TSN's own naming
    tops = [0, 0, 4 * t, 4 * t, 2 * t, 2 * t, 2 * t, 4 * t, 0,
            1 * t, 1 * t, 3 * t, 3 * t]
    lefts = [0, 4 * l, 0, 4 * l, 2 * l, 0, 4 * l, 2 * l, 2 * l,
             1 * l, 3 * l, 1 * l, 3 * l]
    return tops, lefts


@functools.lru_cache(maxsize=64)
def _ms_weight_tables(h: int, w: int, crop_size: int):
    """Per-(h, w) tables: RH [P, crop, h] and CW [P, w, crop] hold each
    pair's PIL resize weights left-aligned in zero planes; TOPS/LEFTS
    [P, 13] the fixed offsets. Rolling a pair's planes by its offset aligns
    them with the crop region, and the zero columns drop the wrap."""
    pairs = _ms_crop_pairs(h, w, crop_size)
    p = len(pairs)
    rh = np.zeros((p, crop_size, h), np.float32)
    cw_t = np.zeros((p, w, crop_size), np.float32)
    tops = np.zeros((p, 13), np.int64)
    lefts = np.zeros((p, 13), np.int64)
    for i, (ch, cwid) in enumerate(pairs):
        rh[i, :, :ch] = resize_ops.resize_weights_cached(ch, crop_size)
        cw_t[i, :cwid, :] = resize_ops.resize_weights_cached(cwid,
                                                             crop_size).T
        tops[i], lefts[i] = _ms_fix_offsets(h - ch, w - cwid)
    return rh, cw_t, tops, lefts


def _rolled(table: np.ndarray, pick: list[int], shift: list[int], axis: int,
            device) -> torch.Tensor:
    """table[pick[b]] rolled by shift[b] along ``axis`` (1 or 2 of the
    result), stacked over b, as an f32 tensor on ``device``."""
    return torch.from_numpy(np.stack([np.roll(table[p], s, axis=axis - 1)
                                      for p, s in zip(pick, shift)])).to(
        device)


def preprocess_train_multiscale(keys: torch.Tensor, frames_u8: torch.Tensor,
                                *, scale_size: int = 256,
                                crop_size: int = 224,
                                dtype=torch.float32) -> torch.Tensor:
    """TSN GroupMultiScaleCrop + random flip per clip: uint8 [B, K, H, W, 3]
    with keys [B, 2] -> normalized [B, K, crop, crop, 3] in ``dtype``."""
    x = resize_ops.resize_short_side(frames_u8.to(torch.float32), scale_size)
    h, w = x.shape[-3], x.shape[-2]
    rh, cw_t, tops, lefts = _ms_weight_tables(h, w, crop_size)
    with trace.span("train.keys"):
        k_scale, k_pos, k_flip = prng.split(keys, 3).unbind(-2)
        pair = prng.randint(k_scale, (), 0, len(tops)).tolist()
        pos = prng.randint(k_pos, (), 0, 13).tolist()
        top = [int(tops[p, q]) for p, q in zip(pair, pos)]
        left = [int(lefts[p, q]) for p, q in zip(pair, pos)]
    wh = _rolled(rh, pair, top, 2, x.device)       # [B, crop, h]
    ww = _rolled(cw_t, pair, left, 1, x.device)    # [B, w, crop]
    y = torch.einsum("boh,bkhwc->bkowc", wh, x)
    x = torch.einsum("bwp,bkowc->bkopc", ww, y)
    return normalize(_flip(x, prng.bernoulli(k_flip)), dtype)
