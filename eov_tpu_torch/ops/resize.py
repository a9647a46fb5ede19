"""PIL-semantics antialiased bilinear resize as two matmuls (PyTorch).

Counterpart of ``eov_tpu/ops/resize.py``: the separable PIL filter weights
are computed on the host in float64 (PIL's support/center formula) and the
resize is ``Wh @ img @ Ww^T``. Like the reference, this is plain tensor code
(two ``torch.matmul``), not a hand kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["scale_short_side_size", "bilinear_weights",
           "resize_weights_cached", "resize_hw", "resize_short_side"]


def scale_short_side_size(h: int, w: int, size: int) -> tuple[int, int]:
    """Output (oh, ow) for torchvision ``Scale(size)``: short side -> size,
    long side scaled with int() truncation; a frame already there keeps its
    size."""
    if h <= w:
        if h == size:
            return h, w
        return size, int(size * w / h)
    if w == size:
        return h, w
    return int(size * h / w), size


def bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out_size, in_size] PIL-exact antialiased bilinear weights
    (triangle filter, support widened by the downscale factor, rows summing
    to 1), float64."""
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


@functools.lru_cache(maxsize=256)
def resize_weights_cached(in_size: int, out_size: int) -> np.ndarray:
    """float32 weight matrix, cached per (in, out) pair."""
    return bilinear_weights(in_size, out_size).astype(np.float32)


def resize_hw(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize [..., H, W, C] float -> [..., out_h, out_w, C] in img's dtype.

    float32 runs in full float32 (TF32 off, see models.folded_infer), the
    counterpart of the reference's ``Precision.HIGHEST``; bf16 runs in bf16
    with float32 accumulation.
    """
    h, w = img.shape[-3], img.shape[-2]
    wh = torch.from_numpy(resize_weights_cached(h, out_h)).to(img.device,
                                                              img.dtype)
    ww = torch.from_numpy(resize_weights_cached(w, out_w)).to(img.device,
                                                              img.dtype)
    y = torch.einsum("oh,...hwc->...owc", wh, img)
    return torch.einsum("pw,...owc->...opc", ww, y)


def resize_short_side(img: torch.Tensor, size: int) -> torch.Tensor:
    """torchvision-``Scale`` resize of [..., H, W, C]: short side -> size."""
    h, w = img.shape[-3], img.shape[-2]
    oh, ow = scale_short_side_size(h, w, size)
    if (oh, ow) == (h, w):
        return img
    return resize_hw(img, oh, ow)
