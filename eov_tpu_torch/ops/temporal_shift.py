"""TSM's temporal shift (Lin, Gan, Han 2019, arXiv:1811.08383), forward
and adjoint, for ``tsm_nl_resnet50``.

A batch of clips of T frames is ``[N*T, C, H, W]`` (the train model's NCHW
view of channels_last memory; clip n is rows n*T .. n*T+T-1). With
``fold`` channels each way, the forward gives

* ``u[t, 0:fold] = x[t + 1, 0:fold]``, zero at t = T - 1;
* ``u[t, fold:2fold] = x[t - 1, fold:2fold]``, zero at t = 0;
* ``u[t, 2fold:] = x[t, 2fold:]``;

and its adjoint (``reverse=True``) is the same copy with the two
directions swapped, so <shift x, y> = <x, shift* y>. ``temporal_shift`` is
one autograd ``Function`` of the two. The CUDA kernel is
``csrc/temporal_shift.cu``; ``shift_plain`` is its oracle and the CPU
path. A copy is exact in any dtype, so the two are bit-equal.

A kernel launch counts ``launch.temporal_shift``.
"""

from __future__ import annotations

import ctypes

import torch

from eov_tpu_torch.ops import _cuda
from eov_tpu_torch.utils import trace

__all__ = ["temporal_shift", "shift_plain", "shift_cuda"]


def _check(x: torch.Tensor, t: int, fold: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected [N*T, C, H, W], got {tuple(x.shape)}")
    if t < 1 or x.shape[0] % t:
        raise ValueError(f"{x.shape[0]} frames are not whole clips of "
                         f"T={t} segments")
    if not 0 <= 2 * fold <= x.shape[1]:
        raise ValueError(f"fold {fold} out of range for {x.shape[1]} "
                         "channels")


def shift_plain(x: torch.Tensor, t: int, fold: int,
                reverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version: slices of a zeroed copy; channels_last."""
    _check(x, t, fold)
    v = x.reshape(x.shape[0] // t, t, *x.shape[1:])
    out = torch.zeros_like(v)
    nxt, prv = slice(0, fold), slice(fold, 2 * fold)
    if reverse:
        nxt, prv = prv, nxt
    out[:, :-1, nxt] = v[:, 1:, nxt]
    out[:, 1:, prv] = v[:, :-1, prv]
    out[:, :, 2 * fold:] = v[:, :, 2 * fold:]
    return out.reshape(x.shape).contiguous(memory_format=torch.channels_last)


def _lib():
    lib = _cuda.load("temporal_shift")
    fn = lib.temporal_shift_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def shift_cuda(x: torch.Tensor, t: int, fold: int,
               reverse: bool = False) -> torch.Tensor:
    """The CUDA kernel, on a CUDA tensor (made channels_last here)."""
    _check(x, t, fold)
    if x.device.type != "cuda":
        raise ValueError(f"shift_cuda needs a CUDA tensor, got {x.device}")
    x = x.contiguous(memory_format=torch.channels_last)
    out = torch.empty_like(x, memory_format=torch.channels_last)
    nt, c, h, w = x.shape
    code = _lib().temporal_shift_launch(
        _cuda.ptr(x), _cuda.ptr(out), nt, t, h * w, c, fold,
        x.element_size(), int(reverse), _cuda.stream_ptr(x.device))
    _cuda.check(code, "temporal_shift")
    trace.count("launch.temporal_shift")
    return out


def _shift(x: torch.Tensor, t: int, fold: int, reverse: bool):
    kind = x.device.type
    if kind == "cuda":
        return shift_cuda(x, t, fold, reverse)
    if kind == "cpu":
        return shift_plain(x, t, fold, reverse)
    raise ValueError(f"temporal_shift: unsupported device {x.device}")


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, t, fold):
        ctx.t, ctx.fold = t, fold
        return _shift(x, t, fold, False)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.t, ctx.fold, True), None, None


def temporal_shift(x: torch.Tensor, t: int, fold: int) -> torch.Tensor:
    """[N*T, C, H, W] -> the shifted copy (module doc), channels_last;
    differentiable (its gradient is the adjoint shift)."""
    return _Shift.apply(x, t, fold)
