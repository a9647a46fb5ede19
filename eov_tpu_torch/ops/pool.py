"""The stem's 3x3 / stride-2 max-pool of a non-negative map (kernel 6).

Counterpart of ``eov_tpu/ops/pallas_pool.py:maxpool_3x3_s2_nonneg``: NHWC
``[N, H, W, C]`` with H and W even -> ``[N, H/2, W/2, C]``, padded with 0.
That equals ``nn.MaxPool2d(3, 2, 1)`` (whose pad is -inf) whenever the input
is >= 0, as the post-ReLU stem map is; the contract is the caller's and is
not checked, as in the reference. The CUDA kernel is
``csrc/maxpool_s2.cu``; the plain version below is its oracle and the CPU
path. ``maxpool_3x3_s2_nonneg`` picks by the tensor's device.

``maxpool_3x3_s2_vjp`` is the train stem's pool with the reference's
custom backward (``eov_tpu/ops/pool.py:maxpool_3x3_s2_vjp``, an XLA op,
not a Pallas kernel): the forward is the plain 3x3/s2/p1 max-pool with
-inf padding; the backward routes each window's cotangent to the FIRST
maximal tap in row-major (dy, dx) order and sums the nine taps' parts in
that order in the cotangent's dtype, so ties (whole zero windows after the
stem ReLU) and the rounding of overlapping windows' sums are the
reference's, bit for bit. ``F.max_pool2d``'s own backward routes ties by
its own rule.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from eov_tpu_torch.ops import _cuda
from eov_tpu_torch.utils import trace

__all__ = ["maxpool_3x3_s2_nonneg", "maxpool_plain", "maxpool_cuda",
           "maxpool_3x3_s2_vjp"]

_DTYPES = (torch.float32, torch.bfloat16)


def _check(x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected NHWC [N, H, W, C], got {tuple(x.shape)}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"even H/W required, got {x.shape[1]}x{x.shape[2]}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"dtype must be one of {_DTYPES}, got {x.dtype}")


def maxpool_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: zero-pad, then an unpadded 3x3/s2 max-pool."""
    _check(x)
    y = F.max_pool2d(F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1)), 3, 2)
    return y.permute(0, 2, 3, 1).contiguous()


def _lib():
    lib = _cuda.load("maxpool_s2")
    fn = lib.maxpool_s2_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def maxpool_cuda(x: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel, on a contiguous CUDA tensor."""
    _check(x)
    if x.device.type != "cuda":
        raise ValueError(f"maxpool_cuda needs a CUDA tensor, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("maxpool_cuda needs a contiguous NHWC x")
    n, h, w, c = x.shape
    out = torch.empty(n, h // 2, w // 2, c, dtype=x.dtype, device=x.device)
    code = _lib().maxpool_s2_launch(
        _cuda.ptr(x), _cuda.ptr(out), n, h, w, c,
        int(x.dtype == torch.bfloat16), _cuda.stream_ptr(x.device))
    _cuda.check(code, "maxpool_s2")
    trace.count("launch.maxpool_3x3_s2_nonneg")
    return out


def maxpool_3x3_s2_nonneg(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] (>= 0, H and W even) -> [N, H/2, W/2, C]: the kernel on
    a CUDA tensor, the plain version on a CPU tensor."""
    kind = x.device.type
    if kind == "cuda":
        return maxpool_cuda(x)
    if kind == "cpu":
        return maxpool_plain(x)
    raise ValueError(f"maxpool_3x3_s2_nonneg: unsupported device {x.device}")


class _MaxPoolVJP(torch.autograd.Function):
    """NHWC 3x3/s2/p1 max-pool with the reference's first-max backward."""

    @staticmethod
    def forward(ctx, x):
        y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1)  # -inf padding
        y = y.permute(0, 2, 3, 1).contiguous()
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        n, h, w, c = x.shape
        oh, ow = y.shape[1], y.shape[2]
        xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=float("-inf"))
        # Padded input frame, one row/column larger for odd H/W, as the
        # reference's interior-dilated scatter lands.
        dxp = torch.zeros(n, 2 * oh + 2, 2 * ow + 2, c, dtype=g.dtype,
                          device=g.device)
        seen = None
        for dy in range(3):
            for dx in range(3):
                # Tap (dy, dx) of every window, at output resolution.
                tap = xp[:, dy:dy + 2 * oh - 1:2, dx:dx + 2 * ow - 1:2]
                eq = tap == y
                first = eq if seen is None else eq & ~seen
                seen = eq if seen is None else seen | eq
                # Back to input coordinates (stride 2, offset by the tap),
                # added in g's dtype in tap order.
                dxp[:, dy:dy + 2 * oh - 1:2, dx:dx + 2 * ow - 1:2] += \
                    torch.where(first, g, torch.zeros((), dtype=g.dtype))
        return dxp[:, 1:h + 1, 1:w + 1].contiguous()


def maxpool_3x3_s2_vjp(x: torch.Tensor) -> torch.Tensor:
    """NHWC [N, H, W, C] -> [N, (H-1)//2+1, (W-1)//2+1, C], any sign, any
    H/W; differentiable with the reference's tie routing (module doc)."""
    if x.dim() != 4:
        raise ValueError(f"expected NHWC [N, H, W, C], got {tuple(x.shape)}")
    return _MaxPoolVJP.apply(x)
