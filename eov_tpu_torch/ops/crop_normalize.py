"""Fused uint8 center crop + ImageNet normalize (kernel 1 of the port).

Counterpart of ``eov_tpu/ops/pallas_preprocess.py:crop_normalize``. For
frames stored at the eval scale (short side == scale_size) the whole eval
transform chain is crop + normalize; the CUDA kernel
(``csrc/crop_normalize.cu``) does it in one pass over the crop window, so
the cropped float intermediate never exists in device memory.

``crop_normalize`` picks by the tensor's device: the plain PyTorch version
for a CPU tensor, the kernel for a CUDA tensor. There is no fallback from
the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from eov_tpu_torch.ops import _cuda
from eov_tpu_torch.ops.preprocess import NORM_BIAS, NORM_SCALE, center_crop
from eov_tpu_torch.utils import trace

__all__ = ["crop_normalize", "crop_normalize_plain", "crop_normalize_cuda"]

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _check(frames_u8: torch.Tensor, crop: int, dtype) -> tuple[int, int]:
    if frames_u8.dtype != torch.uint8:
        raise TypeError(f"expected uint8 frames, got {frames_u8.dtype}")
    if frames_u8.dim() < 3 or frames_u8.shape[-1] != 3:
        raise ValueError("expected channels-last RGB [..., H, W, 3]")
    h, w = frames_u8.shape[-3], frames_u8.shape[-2]
    if h < crop or w < crop:
        raise ValueError(f"frame {h}x{w} smaller than crop {crop}")
    if dtype not in _OUT_DTYPES:
        raise TypeError(f"output dtype must be one of {_OUT_DTYPES}")
    return h, w


@functools.lru_cache(maxsize=None)
def _affine64(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 scale and bias, widened to float64, resident on device."""
    return (torch.from_numpy(NORM_SCALE).to(device, torch.float64),
            torch.from_numpy(NORM_BIAS).to(device, torch.float64))


def crop_normalize_plain(frames_u8: torch.Tensor, *, crop: int = 224,
                         dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version: crop, then ``x*scale - bias`` rounded once to
    f32 (computed in float64, where it is exact), then cast on store."""
    _check(frames_u8, crop, dtype)
    x = center_crop(frames_u8, crop).to(torch.float64)
    scale, bias = _affine64(x.device)
    return (x * scale - bias).to(torch.float32).to(dtype)


def _lib():
    lib = _cuda.load("crop_normalize")
    fn = lib.crop_normalize_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, ctypes.c_ulonglong, p, ll, i, i, i,
                       ctypes.POINTER(ctypes.c_float),
                       ctypes.POINTER(ctypes.c_float), i, p]
        fn.restype = ctypes.c_int
    return fn


def crop_normalize_cuda(frames_u8: torch.Tensor, *, crop: int = 224,
                        dtype=torch.bfloat16) -> torch.Tensor:
    """The CUDA kernel on a CUDA uint8 tensor [..., H, W, 3]."""
    h, w = _check(frames_u8, crop, dtype)
    if frames_u8.device.type != "cuda":
        raise ValueError(f"crop_normalize_cuda needs a CUDA tensor, got "
                         f"{frames_u8.device}")
    if not frames_u8.is_contiguous():
        raise ValueError("crop_normalize_cuda needs a contiguous tensor")
    lead = frames_u8.shape[:-3]
    b = frames_u8.numel() // (h * w * 3)
    out = torch.empty((*lead, crop, crop, 3), dtype=dtype,
                      device=frames_u8.device)
    scale = (ctypes.c_float * 3)(*NORM_SCALE.tolist())
    bias = (ctypes.c_float * 3)(*NORM_BIAS.tolist())
    # The kernel takes any base alignment and reads only inside the
    # tensor's numel() bytes; it centers the crop as center_crop does.
    code = _lib()(
        _cuda.ptr(frames_u8), frames_u8.numel(), _cuda.ptr(out), b, h, w,
        crop, scale, bias, int(dtype == torch.bfloat16),
        _cuda.stream_ptr(frames_u8.device),
    )
    _cuda.check(code, "crop_normalize")
    trace.count("launch.crop_normalize")
    return out


def crop_normalize(frames_u8: torch.Tensor, *, crop: int = 224,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """Center crop + normalize: uint8 [..., H, W, 3] -> dtype [..., crop,
    crop, 3]. Kernel on a CUDA tensor, plain version on a CPU tensor."""
    kind = frames_u8.device.type
    if kind == "cuda":
        return crop_normalize_cuda(frames_u8, crop=crop, dtype=dtype)
    if kind == "cpu":
        return crop_normalize_plain(frames_u8, crop=crop, dtype=dtype)
    raise ValueError(f"crop_normalize: unsupported device {frames_u8.device}")
