"""Fused stride-1 ResNet bottleneck stack (kernel 2 of the port).

Counterpart of ``eov_tpu/ops/pallas_bottleneck.py`` (``pack_bottleneck_params``
and ``fused_bottleneck_stack``). A stack of stride-1 bottleneck blocks (a
projection shortcut allowed on the first) runs over activations flattened
to ``[N, H*W, C]`` (NHWC memory, i.e. a channels_last map). The CUDA kernel
(``csrc/bottleneck_stack.cu``) fuses each block's three convs, biases,
residual and ReLUs so the block's intermediate maps never reach device
memory; the wrapper launches it once per block.

Rounding follows the reference chain (``_run_chain``): f32 accumulation,
y1 and y2 rounded to the compute dtype after bias+ReLU, and
``y3 + b3 + residual`` summed in f32 before the last ReLU and one rounding.
The plain PyTorch version below computes exactly that and is the kernel's
oracle. ``fused_bottleneck_stack`` picks by the tensor's device.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F

from eov_tpu_torch.ops import _cuda

__all__ = ["pack_bottleneck_params", "fused_bottleneck_stack",
           "bottleneck_stack_plain", "bottleneck_stack_cuda",
           "stack_flops_per_img"]

_DTYPES = (torch.float32, torch.bfloat16)
_WEIGHTS = ("w1", "w2", "w3", "wd")
_MAX_SMEM = 232448  # bytes of shared memory a block may use on Hopper


def pack_bottleneck_params(block: Mapping[str, Mapping[str, torch.Tensor]],
                           dtype=torch.float32) -> dict:
    """A folded bottleneck block -> the flat arrays the kernel consumes.

    ``block`` maps conv names (``conv1``, ``conv2``, ``conv3`` and optionally
    ``downsample``) to ``{"weight": OIHW, "bias": [C]}`` (models.resnet
    ``fold_batchnorm`` output). Weights come out in ``dtype``: 1x1 convs as
    ``[Cin, Cout]``, the 3x3 as ``[9, Cin, Cout]`` tap-major (ky*3+kx);
    biases stay f32.
    """
    def one_by_one(name):
        return block[name]["weight"][:, :, 0, 0].t().to(dtype).contiguous()

    def bias(name):
        return block[name]["bias"].to(torch.float32).contiguous()

    w2 = block["conv2"]["weight"]  # [O, I, 3, 3]
    out = {
        "w1": one_by_one("conv1"), "b1": bias("conv1"),
        "w2": w2.permute(2, 3, 1, 0).reshape(9, w2.shape[1], w2.shape[0])
                .to(dtype).contiguous(),
        "b2": bias("conv2"),
        "w3": one_by_one("conv3"), "b3": bias("conv3"),
    }
    if "downsample" in block:
        out["wd"] = one_by_one("downsample")
        out["bd"] = bias("downsample")
    return out


def stack_flops_per_img(blocks: Sequence[Mapping[str, torch.Tensor]],
                        p: int) -> int:
    """Multiply-add flops (x2) of the stack per image of p pixels."""
    flops = 0
    for b in blocks:
        cin, cmid = b["w1"].shape
        cout = b["w3"].shape[1]
        flops += 2 * p * (cin * cmid + 9 * cmid * cmid + cmid * cout)
        if "wd" in b:
            flops += 2 * p * cin * cout
    return flops


def _check(x: torch.Tensor, blocks, h: int, w: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"expected x [N, H*W, C], got {tuple(x.shape)}")
    if x.shape[1] != h * w:
        raise ValueError(f"x rows {x.shape[1]} != h*w {h * w}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"compute dtype must be one of {_DTYPES}")
    if not blocks:
        raise ValueError("empty block stack")
    c = x.shape[2]
    for i, b in enumerate(blocks):
        missing = [k for k in ("w1", "b1", "w2", "b2", "w3", "b3")
                   if k not in b]
        if missing or (("wd" in b) != ("bd" in b)):
            raise KeyError(f"block {i} is missing kernel params "
                           f"{missing or ['wd/bd pair']}")
        cin, cmid = b["w1"].shape
        if cin != c:
            raise ValueError(f"block {i} takes {cin} channels, gets {c}")
        if tuple(b["w2"].shape) != (9, cmid, cmid) or b["w3"].shape[0] != cmid:
            raise ValueError(f"block {i}: inconsistent w2/w3 shapes")
        cout = b["w3"].shape[1]
        if "wd" not in b and cin != cout:
            raise ValueError(f"block {i} needs a projection: {cin} -> {cout}")
        c = cout


def _bias(b: torch.Tensor) -> torch.Tensor:
    return b.reshape(-1).to(torch.float32)


def bottleneck_stack_plain(x: torch.Tensor, blocks, *, h: int,
                           w: int) -> torch.Tensor:
    """Plain PyTorch version of the stack (the kernel's oracle).

    The 3x3 is nine shifted matmuls over the zero-padded y1 map, as in the
    reference. Matmuls run in f32 on f32-widened operands (exact products of
    bf16 values); on a GPU the caller keeps TF32 off.
    """
    _check(x, blocks, h, w)
    dt, n = x.dtype, x.shape[0]
    for b in blocks:
        xf = x.float()
        y1 = torch.relu(xf @ b["w1"].float() + _bias(b["b1"])).to(dt)
        cmid = y1.shape[-1]
        pad = F.pad(y1.reshape(n, h, w, cmid), (0, 0, 1, 1, 1, 1))
        w2 = b["w2"].float()
        acc = torch.zeros(n, h * w, cmid, device=x.device)
        for ky in range(3):
            for kx in range(3):
                tap = pad[:, ky:ky + h, kx:kx + w, :].reshape(n, h * w, cmid)
                acc = acc + tap.float() @ w2[ky * 3 + kx]
        y2 = torch.relu(acc + _bias(b["b2"])).to(dt)
        y3 = y2.float() @ b["w3"].float() + _bias(b["b3"])
        res = xf @ b["wd"].float() + _bias(b["bd"]) if "wd" in b else xf
        x = torch.relu(y3 + res).to(dt)
    return x


def _lib():
    lib = _cuda.load("bottleneck_stack")
    fn = lib.bottleneck_block_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
        lib.bottleneck_block_smem_bytes.argtypes = [i, i, i, i]
        lib.bottleneck_block_smem_bytes.restype = ctypes.c_longlong
    return lib


def tile_rows(h: int, w: int) -> int:
    """Output rows per thread block: as many as fit a 128-pixel tile."""
    if w > 128:
        raise ValueError(f"map width {w} > 128 is not supported by the "
                         "bottleneck kernel's 128-pixel tiles")
    return max(1, min(h, 128 // w))


def bottleneck_stack_cuda(x: torch.Tensor, blocks, *, h: int,
                          w: int) -> torch.Tensor:
    """The CUDA kernel, one launch per block, on CUDA tensors.

    Weights must already be packed in x's dtype (``pack_bottleneck_params``)
    and biases f32, all contiguous on x's device.
    """
    _check(x, blocks, h, w)
    if x.device.type != "cuda":
        raise ValueError(f"bottleneck_stack_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("bottleneck_stack_cuda needs a contiguous x")
    for b in blocks:
        for k, v in b.items():
            want = x.dtype if k in _WEIGHTS else torch.float32
            if v.dtype != want or v.device != x.device or \
                    not v.is_contiguous():
                raise ValueError(f"param {k} must be a contiguous {want} "
                                 f"tensor on {x.device}")
    lib = _lib()
    bf16 = int(x.dtype == torch.bfloat16)
    tr = tile_rows(h, w)
    stream = _cuda.stream_ptr(x.device)
    n = x.shape[0]
    for b in blocks:
        cin, cmid = b["w1"].shape
        cout = b["w3"].shape[1]
        smem = lib.bottleneck_block_smem_bytes(bf16, w, cmid, tr)
        if smem > _MAX_SMEM:
            raise ValueError(f"bottleneck tile needs {smem} B of shared "
                             f"memory (> {_MAX_SMEM}) at w={w}, cmid={cmid}")
        out = torch.empty(n, h * w, cout, dtype=x.dtype, device=x.device)
        proj = "wd" in b
        code = lib.bottleneck_block_launch(
            _cuda.ptr(x), _cuda.ptr(b["w1"]), _cuda.ptr(b["b1"]),
            _cuda.ptr(b["w2"]), _cuda.ptr(b["b2"]), _cuda.ptr(b["w3"]),
            _cuda.ptr(b["b3"]),
            _cuda.ptr(b["wd"]) if proj else None,
            _cuda.ptr(b["bd"]) if proj else None,
            _cuda.ptr(out), n, h, w, cin, cmid, cout, tr, bf16, stream,
        )
        _cuda.check(code, "bottleneck_stack")
        fused_bottleneck_stack.launches += 1
        x = out
    return x


def fused_bottleneck_stack(x: torch.Tensor, blocks, *, h: int,
                           w: int) -> torch.Tensor:
    """[N, H*W, Cin] -> [N, H*W, Cout] through the block stack: the kernel
    on a CUDA tensor, the plain version on a CPU tensor."""
    kind = x.device.type
    if kind == "cuda":
        return bottleneck_stack_cuda(x, blocks, h=h, w=w)
    if kind == "cpu":
        return bottleneck_stack_plain(x, blocks, h=h, w=w)
    raise ValueError(f"fused_bottleneck_stack: unsupported device {x.device}")


fused_bottleneck_stack.launches = 0
