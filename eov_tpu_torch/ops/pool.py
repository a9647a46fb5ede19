"""The stem's 3x3 / stride-2 max-pool of a non-negative map (kernel 6).

Counterpart of ``eov_tpu/ops/pallas_pool.py:maxpool_3x3_s2_nonneg``: NHWC
``[N, H, W, C]`` with H and W even -> ``[N, H/2, W/2, C]``, padded with 0.
That equals ``nn.MaxPool2d(3, 2, 1)`` (whose pad is -inf) whenever the input
is >= 0, as the post-ReLU stem map is; the contract is the caller's and is
not checked, as in the reference. The CUDA kernel is
``csrc/maxpool_s2.cu``; the plain version below is its oracle and the CPU
path. ``maxpool_3x3_s2_nonneg`` picks by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from eov_tpu_torch.ops import _cuda

__all__ = ["maxpool_3x3_s2_nonneg", "maxpool_plain", "maxpool_cuda"]

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
    maxpool_3x3_s2_nonneg.launches += 1
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


maxpool_3x3_s2_nonneg.launches = 0
