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
tensor's device. The kernel runs its products on the int8 tensor cores in
both compute dtypes, over tiles from ``int8_tile_plan`` and weights relaid
out by ``_int8_mma_weights``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping

import torch
import torch.nn.functional as F

from eov_tpu_torch.ops import _cuda
from eov_tpu_torch.ops.bottleneck import _kmajor_tiles, _mma_weights
from eov_tpu_torch.utils import trace

__all__ = ["pack_bottleneck_params_int8", "prepare_site", "int_mm",
           "quantize_act", "fused_bottleneck_stack_int8",
           "bottleneck_stack_int8_plain", "bottleneck_stack_int8_cuda",
           "int8_tile_plan"]

_DTYPES = (torch.float32, torch.bfloat16)
_KEYS = ("w1", "s1", "q1", "b1", "w2", "s2", "q2", "b2",
         "w3", "s3", "q3", "b3")
_PROJ = ("wd", "sd", "qd", "bd")
_MAX_SMEM = 232448  # bytes of shared memory a block may use on Hopper
_STAGES = 3         # weight tiles in flight (kStages)
_ZERO = 128         # the zero line (kZeroBytes)
_MROWS = 512        # M rows of a pass: the 8 warps x 64 rows of products
# Bytes one SM's share of device memory moves in the time of one K step at
# the int8 tensor-core peak (H100: 3.35 TB/s / 132 SMs x (512 x 64 x 64 x 2
# ops / (1979 TOPS / 132))): the plan's exchange rate of bytes for steps.
_STEP_BYTES = 7100


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
        fn.argtypes = [p] * 17 + [i] * 17 + [p]
        fn.restype = ctypes.c_int
        lib.bottleneck_int8_smem_bytes.argtypes = [i] * 9
        lib.bottleneck_int8_smem_bytes.restype = ctypes.c_longlong
    return lib


def _int8_smem(h: int, w: int, cinp: int, cmidp: int, tr: int, g: int,
               wn1: int, wn3: int, proj: bool) -> int:
    """Shared memory of one kernel-7 block (``int8_smem`` in
    bottleneck_int8.cu): the weight ring, the zero line, the int8 x tile
    over the block's rows and halo at all of cin's channels (y2 takes its
    place after conv1), y1 over the same rows, and on an entry block the
    projection's x over the output rows."""
    yrows = min(tr + 2, h)
    px_in, px_out = g * yrows * w, g * tr * w
    ring = 64 * 64 * max(wn1, wn3)
    xd = px_out * cinp if proj else 0
    return _STAGES * ring + _ZERO + max(px_in * cinp, px_out * cmidp) \
        + px_in * cmidp + xd


def int8_tile_plan(h: int, w: int, cin: int, cmid: int, cout: int,
                   n: int = 1, proj: bool | None = None) -> dict:
    """The kernel's tiling of one int8 block over an [n, h*w, cin] map.

    Channels are padded with zeros to multiples of 64 (``cinp``, ``cmidp``,
    ``coutp``; a K step is one 64-channel plane). conv1 and conv2 run in N
    passes of ``64 wn1`` channels (wn1 1 or 2) and M passes of ``m_tile =
    512 / wn1`` pixels, conv3 and the projection in passes of ``64 wn3``
    and ``m_tile_out = 512 / wn3``. Of the tile heights (``tile_rows``;
    with the whole map, ``images`` maps per block, at most ``n``) and pass
    widths whose block fits the shared memory, the plan takes the one with
    the least cost per image, then the most rows a block, then the least
    shared memory. The cost counts K steps (one 64-deep product of a whole
    M x N pass and one barrier; every step is 512 x 64 x 64 products) and
    the block's input rows (halo included) and output rows in bf16 bytes,
    at ``_STEP_BYTES`` a step: a block stages its input before its first
    product, so a halo row costs as much as the steps its bytes take to
    arrive. Returns those, ``smem``, ``steps`` per image, ``cost``,
    ``halo`` (the staged rows over the output rows, (TR + 2) / TR when TR
    < h) and the launch ``grid`` (row tiles, image groups). ``proj``: the
    block has a projection shortcut (default: when cin != cout)."""
    if proj is None:
        proj = cin != cout
    return dict(_int8_plan(h, w, cin, cmid, cout, n, bool(proj)))


def _int8_cost(h: int, w: int, cin: int, cmid: int, cout: int, proj: bool,
               tr: int, g: int, wn1: int, wn3: int) -> tuple[int, float]:
    """(K steps, cost) of the blocks that cover g images: cost = the steps
    plus the bf16 bytes of the blocks' input rows (halo included) and
    output rows at ``_STEP_BYTES`` a step."""
    kin, kmid, kout = (-(-c // 64) for c in (cin, cmid, cout))
    kc = kmid + (kin if proj else 0)  # conv3's K steps (+ the projection)
    mt1, mt3 = _MROWS // wn1, _MROWS // wn3
    steps = io = 0
    for r0 in range(0, h, tr):
        rows = min(tr, h - r0)
        ra = min(r0 + rows + 1, h) - max(r0 - 1, 0)
        mb = g * rows * w
        steps += (-(-g * ra * w // mt1) * (kmid // wn1) * kin
                  + -(-mb // mt1) * (kmid // wn1) * kmid * 9
                  + -(-mb // mt3) * (kout // wn3) * kc)
        io += 2 * g * w * (ra * cin + rows * cout)
    return steps, steps + io / _STEP_BYTES


@functools.lru_cache(maxsize=256)
def _int8_plan(h: int, w: int, cin: int, cmid: int, cout: int, n: int,
               proj: bool) -> dict:
    """``int8_tile_plan``, searched once per shape."""
    cinp, cmidp, coutp = (-(-c // 64) * 64 for c in (cin, cmid, cout))
    kmid, kout = cmidp // 64, coutp // 64

    best = None
    for wn1 in (v for v in (1, 2) if kmid % v == 0):
        for wn3 in (v for v in (1, 2, 4) if kout % v == 0):
            for tr in range(1, h + 1):
                for g in range(1, (n if tr == h else 1) + 1):
                    smem = _int8_smem(h, w, cinp, cmidp, tr, g, wn1, wn3,
                                      proj)
                    if smem > _MAX_SMEM:
                        break
                    k, cost = _int8_cost(h, w, cin, cmid, cout, proj, tr,
                                         g, wn1, wn3)
                    key = (cost / g, -tr * g, smem)
                    if best is None or key < best[0]:
                        best = (key, tr, g, wn1, wn3, k / g)
    if best is None:
        least = _int8_smem(h, w, cinp, cmidp, 1, 1, 1, 1, proj)
        raise ValueError(f"int8 bottleneck tile needs {least} B of shared "
                         f"memory (> {_MAX_SMEM}) at w={w}, cin={cin}, "
                         f"cmid={cmid}, one row")
    (cost, _, smem), tr, g, wn1, wn3, per_img = best
    return {"tile_rows": tr, "images": g, "cinp": cinp, "cmidp": cmidp,
            "coutp": coutp, "wn1": wn1, "wn3": wn3,
            "m_tile": _MROWS // wn1, "m_tile_out": _MROWS // wn3,
            "proj": proj, "smem": smem, "steps": per_img, "cost": cost,
            "halo": min(tr + 2, h) / tr,
            "grid": (-(-h // tr), -(-n // g))}


def _int8_mma_weights(b, plan) -> tuple:
    """A packed block's int8 weights as the kernel's K loops read them,
    zero-padded, each tile [NT][64] K-major: w1 [cmidp/NT1][cinp/64][NT1]
    [64], w2 [cmidp/NT1][cmidp/64][9][NT1][64], and w3 with (on an entry
    block) wd's tiles before its own, [coutp/NT3][cinp/64 +
    cmidp/64][NT3][64] (the projection's pass runs first)."""
    cin, cmid = b["w1"].shape
    cout = b["w3"].shape[1]
    cinp, cmidp, coutp = plan["cinp"], plan["cmidp"], plan["coutp"]
    nt1, nt3 = 64 * plan["wn1"], 64 * plan["wn3"]
    w1 = F.pad(b["w1"], (0, cmidp - cmid, 0, cinp - cin))
    w3 = F.pad(b["w3"], (0, coutp - cout, 0, cmidp - cmid))
    if "wd" in b:
        w3 = torch.cat([F.pad(b["wd"], (0, coutp - cout, 0, cinp - cin)), w3])
    return (_kmajor_tiles(w1, nt1), _mma_weights(b["w2"], cmidp, nt1),
            _kmajor_tiles(w3, nt3))


def bottleneck_stack_int8_cuda(x: torch.Tensor, blocks, *, h: int,
                               w: int) -> torch.Tensor:
    """The CUDA kernel, one launch per block, on CUDA tensors (bf16 or f32;
    the products run on the int8 tensor cores in both).

    Weights int8, scales and biases f32, all contiguous on x's device (as
    ``pack_bottleneck_params_int8`` makes them); any channel counts (the
    kernel pads them to 64)."""
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
    lib = _lib()
    bf16 = int(x.dtype == torch.bfloat16)
    stream = _cuda.stream_ptr(x.device)
    n = x.shape[0]
    for b in blocks:
        cin, cmid = b["w1"].shape
        cout = b["w3"].shape[1]
        proj = "wd" in b
        plan = int8_tile_plan(h, w, cin, cmid, cout, n, proj)
        dims = (plan["cinp"], plan["cmidp"], plan["coutp"],
                plan["tile_rows"], plan["images"], plan["wn1"], plan["wn3"])
        smem = lib.bottleneck_int8_smem_bytes(
            h, w, plan["cinp"], plan["cmidp"], plan["tile_rows"],
            plan["images"], plan["wn1"], plan["wn3"], int(proj))
        if smem != plan["smem"]:
            raise RuntimeError(f"int8 plan and kernel disagree on shared "
                               f"memory: {plan['smem']} vs {smem}")
        out = torch.empty(n, h * w, cout, dtype=x.dtype, device=x.device)
        vec = int(cin % 8 == 0 and x.data_ptr() % 16 == 0)
        ovec = int(vec and cout % 8 == 0 and out.data_ptr() % 16 == 0)
        # Held until the launch is enqueued: a relaid-out copy freed before
        # that could hand its memory to the next allocation.
        w1t, w2t, w3t = _int8_mma_weights(b, plan)
        sites = []
        for tag in ("1", "2", "3", "d"):
            for k in ("s", "q", "b"):
                sites.append(_cuda.ptr(b[k + tag]) if proj or tag != "d"
                             else None)
        s1, q1, b1, s2, q2, b2, s3, q3, b3, sd, qd, bd = sites
        code = lib.bottleneck_int8_block_launch(
            _cuda.ptr(x), _cuda.ptr(w1t), s1, q1, b1, _cuda.ptr(w2t), s2, q2,
            b2, _cuda.ptr(w3t), s3, q3, b3, sd, qd, bd, _cuda.ptr(out), n, h,
            w, cin, cmid, cout, *dims, int(proj), vec, ovec, bf16, stream)
        _cuda.check(code, "bottleneck_int8")
        trace.count("launch.fused_bottleneck_stack_int8")
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
