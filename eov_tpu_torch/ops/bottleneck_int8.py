"""Fused stride-1 int8 ResNet bottleneck stack (kernel 7 of the port).

Counterpart of ``eov_tpu/ops/pallas_bottleneck_int8.py``
(``pack_bottleneck_params_int8`` and ``fused_bottleneck_stack_int8``). The
stack runs over activations flattened to ``[N, H*W, C]`` (NHWC memory) in
the compute dtype (bf16 or f32); every conv is quantized. The CUDA kernel
(``csrc/bottleneck_int8.cu``) fuses each block's three convs so that the
block's intermediate maps stay in shared memory as int8; the wrapper
launches it once per block.

Each conv follows ``models/quant_infer.py``'s ``_qconv`` (the reference's
``_run_chain_int8``), and so does every rounding:

    xq  = clip(round(x_f32 * inv_a), -127, 127) -> int8  (round half to even)
    acc = xq @ wq, int8 x int8 summed exactly in int32
    y   = T(acc_f32 * scale)  with scale = a * w_scale per output channel

then the bias is added in the compute dtype T (``T(y + T(b))``), ReLU, and
the next conv requantizes. The block ends ``T(y3 + r)`` (r the projected or
identity residual, both in T), ReLU. This is not kernel 2's chain: there
``y3 + b3 + residual`` is summed once in f32.

The plain PyTorch version below computes exactly that, with the products
summed in int32 (``int_mm``: ``torch._int_mm``, never an f32 matmul), and
is the kernel's oracle. ``fused_bottleneck_stack_int8`` picks by the
tensor's device.
"""

from __future__ import annotations

import ctypes
from typing import Mapping

import torch
import torch.nn.functional as F

from eov_tpu_torch.ops import _cuda

__all__ = ["pack_bottleneck_params_int8", "prepare_site", "int_mm",
           "quantize_act", "fused_bottleneck_stack_int8",
           "bottleneck_stack_int8_plain", "bottleneck_stack_int8_cuda"]

_DTYPES = (torch.float32, torch.bfloat16)
_KEYS = ("w1", "s1", "q1", "b1", "w2", "s2", "q2", "b2",
         "w3", "s3", "q3", "b3")
_PROJ = ("wd", "sd", "qd", "bd")
_MAX_SMEM = 232448  # bytes of shared memory a block may use on Hopper


def prepare_site(qconv: Mapping[str, torch.Tensor]) -> dict:
    """A quantized conv ``{kernel_q int8 OIHW, w_scale f32 [O], a_scale f32
    scalar, bias f32 [O]}`` -> what the int8 matmuls consume:

        wq    int8 [KH*KW*I, O]  rows in (ky, kx, ci) order (im2col order)
        scale f32  [O]           a_scale * w_scale, the dequant multiplier
        inv_a f32  [1]           1 / a_scale, the requant multiplier
        bias  f32  [O]

    ``scale`` and ``inv_a`` are the same f32 products the reference forms.
    """
    kq = qconv["kernel_q"]
    o, i, kh, kw = kq.shape
    a = qconv["a_scale"].to(torch.float32).reshape(1)
    return {
        "wq": kq.permute(2, 3, 1, 0).reshape(kh * kw * i, o).contiguous(),
        "scale": (a * qconv["w_scale"].to(torch.float32)).contiguous(),
        "inv_a": (1.0 / a).contiguous(),
        "bias": qconv["bias"].to(torch.float32).reshape(-1).contiguous(),
        "k": kh,
    }


def pack_bottleneck_params_int8(qblock: Mapping[str, Mapping]) -> dict:
    """A quantized bottleneck block (``conv1``, ``conv2``, ``conv3`` and
    optionally ``downsample``, each as ``prepare_site`` takes it) -> the flat
    arrays the kernel consumes: per site ``w`` int8 (1x1 ``[Cin, Cout]``,
    3x3 ``[9, Cin, Cout]`` tap-major), ``s`` f32 ``[Cout]`` (a * w_scale),
    ``q`` f32 ``[1]`` (1 / a) and the bias ``b`` f32 ``[Cout]``."""
    out = {}
    for tag, name in (("1", "conv1"), ("2", "conv2"), ("3", "conv3"),
                      ("d", "downsample")):
        if name not in qblock:
            continue
        site = prepare_site(qblock[name])
        wq = site["wq"]
        if site["k"] == 3:
            wq = wq.reshape(9, -1, wq.shape[1])
        out.update({f"w{tag}": wq.contiguous(), f"s{tag}": site["scale"],
                    f"q{tag}": site["inv_a"], f"b{tag}": site["bias"]})
    return out


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N], summed exactly in int32.

    ``torch._int_mm`` on both devices. On a GPU (cuBLASLt) it takes M > 16,
    K and N multiples of 8 and, for every N, a column-major B (a row-major
    B is refused at N >= 32 for small M, measured on an H100), so the
    operands are zero-padded there (exact) and B is laid out so."""
    m, k = a.shape
    n = b.shape[1]
    if a.is_cuda:
        pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
        if pm or pk:
            a = F.pad(a, (0, pk, 0, pm))
        if pk or pn:
            b = F.pad(b, (0, pn, 0, pk))
        out = torch._int_mm(a.contiguous(), b.t().contiguous().t())
        return out[:m, :n] if (pm or pn) else out
    return torch._int_mm(a.contiguous(), b.contiguous())


def quantize_act(x: torch.Tensor, inv_a: torch.Tensor) -> torch.Tensor:
    """clip(round(x_f32 * inv_a), -127, 127) as int8; torch.round rounds
    half to even, as jnp.round does."""
    return torch.clamp(torch.round(x.float() * inv_a), -127.0,
                       127.0).to(torch.int8)


def _dequant_bias(acc: torch.Tensor, scale, bias, dt) -> torch.Tensor:
    """T(T(acc_f32 * scale) + T(bias)): dequant, then the bias in T."""
    return (acc.float() * scale).to(dt) + bias.to(dt)


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
        proj = any(k in b for k in _PROJ)
        missing = [k for k in _KEYS + (_PROJ if proj else ()) if k not in b]
        if missing:
            raise KeyError(f"int8 block {i} is missing kernel params "
                           f"{missing}")
        cin, cmid = b["w1"].shape
        if cin != c:
            raise ValueError(f"block {i} takes {cin} channels, gets {c}")
        if tuple(b["w2"].shape) != (9, cmid, cmid) or b["w3"].shape[0] != cmid:
            raise ValueError(f"block {i}: inconsistent w2/w3 shapes")
        cout = b["w3"].shape[1]
        if not proj and cin != cout:
            raise ValueError(f"block {i} needs a projection: {cin} -> {cout}")
        c = cout


def bottleneck_stack_int8_plain(x: torch.Tensor, blocks, *, h: int,
                                w: int) -> torch.Tensor:
    """Plain PyTorch version of the stack (the kernel's oracle): the
    reference's ``_run_chain_int8`` with the 3x3 as nine shifted int8
    matmuls over the zero-padded requantized y1 map."""
    _check(x, blocks, h, w)
    dt, n = x.dtype, x.shape[0]
    for b in blocks:
        flat = x.reshape(n * h * w, -1)
        y1 = torch.relu(_dequant_bias(
            int_mm(quantize_act(flat, b["q1"]), b["w1"]), b["s1"], b["b1"],
            dt))
        cmid = y1.shape[-1]
        pad = F.pad(quantize_act(y1, b["q2"]).reshape(n, h, w, cmid),
                    (0, 0, 1, 1, 1, 1))
        acc = None
        for ky in range(3):
            for kx in range(3):
                tap = pad[:, ky:ky + h, kx:kx + w, :].reshape(-1, cmid)
                part = int_mm(tap, b["w2"][ky * 3 + kx])
                acc = part if acc is None else acc + part
        y2 = torch.relu(_dequant_bias(acc, b["s2"], b["b2"], dt))
        y3 = _dequant_bias(int_mm(quantize_act(y2, b["q3"]), b["w3"]),
                           b["s3"], b["b3"], dt)
        if "wd" in b:
            r = _dequant_bias(int_mm(quantize_act(flat, b["qd"]), b["wd"]),
                              b["sd"], b["bd"], dt)
        else:
            r = flat
        x = torch.relu(y3 + r).reshape(n, h * w, -1)
    return x


def _lib():
    lib = _cuda.load("bottleneck_int8")
    fn = lib.bottleneck_int8_block_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 18 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
        lib.bottleneck_int8_smem_bytes.argtypes = [i, i, i]
        lib.bottleneck_int8_smem_bytes.restype = ctypes.c_longlong
    return lib


def tile_rows(h: int, w: int) -> int:
    """Output rows per thread block: as many as fit a 128-pixel tile."""
    if w > 128:
        raise ValueError(f"map width {w} > 128 is not supported by the int8 "
                         "bottleneck kernel's 128-pixel tiles")
    return max(1, min(h, 128 // w))


def bottleneck_stack_int8_cuda(x: torch.Tensor, blocks, *, h: int,
                               w: int) -> torch.Tensor:
    """The CUDA kernel, one launch per block, on CUDA tensors.

    Weights int8, scales and biases f32, all contiguous on x's device (as
    ``pack_bottleneck_params_int8`` makes them); Cin and Cmid multiples of
    4 (the kernel reads int8 operands four to a 32-bit word)."""
    _check(x, blocks, h, w)
    if x.device.type != "cuda":
        raise ValueError(f"bottleneck_stack_int8_cuda needs a CUDA tensor, "
                         f"got {x.device}")
    if not x.is_contiguous():
        raise ValueError("bottleneck_stack_int8_cuda needs a contiguous x")
    for b in blocks:
        for k, v in b.items():
            want = torch.int8 if k[0] == "w" else torch.float32
            if v.dtype != want or v.device != x.device or \
                    not v.is_contiguous():
                raise ValueError(f"param {k} must be a contiguous {want} "
                                 f"tensor on {x.device}")
        cin, cmid = b["w1"].shape
        if cin % 4 or cmid % 4:
            raise ValueError(f"int8 kernel needs Cin and Cmid multiples of 4,"
                             f" got {cin}, {cmid}")
    lib = _lib()
    bf16 = int(x.dtype == torch.bfloat16)
    tr = tile_rows(h, w)
    stream = _cuda.stream_ptr(x.device)
    n = x.shape[0]
    for b in blocks:
        cin, cmid = b["w1"].shape
        cout = b["w3"].shape[1]
        smem = lib.bottleneck_int8_smem_bytes(w, cmid, tr)
        if smem > _MAX_SMEM:
            raise ValueError(f"int8 bottleneck tile needs {smem} B of shared "
                             f"memory (> {_MAX_SMEM}) at w={w}, cmid={cmid}")
        out = torch.empty(n, h * w, cout, dtype=x.dtype, device=x.device)
        args = [_cuda.ptr(x)]
        for k in _KEYS + _PROJ:
            args.append(_cuda.ptr(b[k]) if k in b else None)
        code = lib.bottleneck_int8_block_launch(
            *args, _cuda.ptr(out), n, h, w, cin, cmid, cout, tr, bf16,
            stream)
        _cuda.check(code, "bottleneck_int8")
        fused_bottleneck_stack_int8.launches += 1
        x = out
    return x


def fused_bottleneck_stack_int8(x: torch.Tensor, blocks, *, h: int,
                                w: int) -> torch.Tensor:
    """[N, H*W, Cin] -> [N, H*W, Cout] through the int8 block stack: the
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    kind = x.device.type
    if kind == "cuda":
        return bottleneck_stack_int8_cuda(x, blocks, h=h, w=w)
    if kind == "cpu":
        return bottleneck_stack_int8_plain(x, blocks, h=h, w=w)
    raise ValueError(f"fused_bottleneck_stack_int8: unsupported device "
                     f"{x.device}")


fused_bottleneck_stack_int8.launches = 0
