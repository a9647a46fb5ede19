"""Eval preprocess: uint8 frames -> ImageNet-normalized NHWC network input.

Counterpart of ``eov_tpu/ops/preprocess.py`` (the TSN test-time chain:
short-side resize -> center crop -> /255 -> normalize). The fused
crop+normalize kernel for storage-normalized frames is
``ops/crop_normalize.py``; this module is its semantics reference.
"""

from __future__ import annotations

import numpy as np
import torch

from eov_tpu_torch.ops import resize as resize_ops

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "NORM_SCALE", "NORM_BIAS",
           "normalize", "center_crop", "preprocess_eval"]

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
