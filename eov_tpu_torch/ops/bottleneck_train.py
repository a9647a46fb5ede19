"""Frozen-BN bottleneck stack of the train step (kernels 8 and 9 of the port).

Counterpart of ``eov_tpu/ops/pallas_bottleneck_train.py``. Under TSN's
partial BN every stage BatchNorm runs on its running statistics, so each
is a constant per-channel affine ``c*s + b``, and a stack of stride-1
bottleneck blocks (ResNet-50 stage 1, or the stride-1 tail of stage 2) is
differentiable in closed form with respect to its input and its conv
kernels only.

* ``pack_train_block`` turns a block of ``models.resnet.ResNet`` into the
  op's dict: the conv kernels as differentiable views of the parameters
  (``w1 [Cin, Cmid]``, ``w2 [9, Cmid, Cmid]`` tap-major, ``w3 [Cmid, Cout]``,
  ``wd [Cin, Cout]`` on a projected block) and the frozen affines
  ``(s, b)`` as constants.
* ``bottleneck_stack_train`` is a ``torch.autograd.Function`` over the
  whole stack. Its forward saves only the stack input (and the weights);
  its backward recomputes the chain and returns dx and the f32 dW of every
  conv kernel, summed over images, and no gradient for the frozen affines.
* Forward and backward each have a plain PyTorch version (the CPU path and
  the kernels' oracle) and a CUDA one (``csrc/bottleneck_train.cu``). A CUDA
  tensor launches the kernels and nothing else; there is no fallback.

Activations cross the op in f32 ``[N, H*W, C]`` (NHWC memory); rounding
follows the reference chain: every conv takes T-rounded operands (T the
compute dtype), accumulates in f32 and rounds its output to T, and the
frozen affine, the ReLUs and the residual sum run in f32 on that rounded
output. Kernel 2's folded-weight formulation rounds elsewhere; the bf16
kernels reuse its tensor-core block (``train_tile_plan``) with the train
chain's epilogues, and the weight gradients tile the pixels
(``train_wgrad_plan``). The plain versions' products run in f32 on
f32-widened operands (exact products of bf16 values); on a GPU the caller
keeps TF32 off (``models.folded_infer.use_full_f32``).
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F

from eov_tpu_torch.ops import _cuda
from eov_tpu_torch.ops.bottleneck import (_MAX_SMEM, _MMA_ZERO,
                                          _bottleneck_mma_weights,
                                          _kmajor_tiles,
                                          bottleneck_tile_plan,
                                          stack_flops_per_img, tile_rows)
from eov_tpu_torch.utils import trace

__all__ = ["pack_train_block", "bottleneck_stack_train",
           "BottleneckStackTrain", "train_stack_forward",
           "train_stack_backward", "train_stack_forward_plain",
           "train_stack_backward_plain", "train_stack_forward_cuda",
           "train_stack_backward_cuda", "train_stack_flops",
           "train_tile_plan", "train_wgrad_plan"]

_DTYPES = (torch.float32, torch.bfloat16)
_BLOCK_KEYS = ("w1", "s1", "b1", "w2", "s2", "b2", "w3", "s3", "b3")
_PROJ_KEYS = ("wd", "sd", "bd")


def pack_train_block(block, eps: float = 1e-5) -> dict:
    """A frozen-BN bottleneck block (``models.resnet.Bottleneck``) -> the
    op's dict. Conv kernels stay views of the parameters (gradients reach
    exactly them); ``s = gamma / sqrt(var + eps)`` and ``b = beta - mean*s``
    are detached constants."""

    def affine(bn):
        s = bn.weight.detach() / torch.sqrt(bn.running_var + eps)
        return s, bn.bias.detach() - bn.running_mean * s

    def one_by_one(conv):
        return conv.weight[:, :, 0, 0].t()

    w2 = block.conv2.weight  # [O, I, 3, 3]
    out = {"w1": one_by_one(block.conv1),
           "w2": w2.permute(2, 3, 1, 0).reshape(9, w2.shape[1], w2.shape[0]),
           "w3": one_by_one(block.conv3)}
    out["s1"], out["b1"] = affine(block.bn1)
    out["s2"], out["b2"] = affine(block.bn2)
    out["s3"], out["b3"] = affine(block.bn3)
    if block.downsample is not None:
        out["wd"] = one_by_one(block.downsample[0])
        out["sd"], out["bd"] = affine(block.downsample[1])
    return out


def train_stack_flops(blocks, p: int, backward: bool = False) -> int:
    """Multiply-add flops (x2) per image of p pixels: the forward, or the
    backward (recompute + dgrad + wgrad, three times the forward)."""
    return stack_flops_per_img(blocks, p) * (3 if backward else 1)


def _check(x: torch.Tensor, blocks, h: int, w: int, dtype) -> None:
    if x.dim() != 3 or x.shape[1] != h * w:
        raise ValueError(f"expected x [N, {h * w}, C], got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"the stack input is f32, got {x.dtype}")
    if dtype not in _DTYPES:
        raise TypeError(f"compute dtype must be one of {_DTYPES}")
    if not blocks:
        raise ValueError("empty block stack")
    c = x.shape[2]
    for i, b in enumerate(blocks):
        missing = [k for k in _BLOCK_KEYS if k not in b]
        if missing or any((k in b) != ("wd" in b) for k in _PROJ_KEYS):
            raise KeyError(f"block {i} lacks {missing or ['wd/sd/bd']}")
        cin, cmid = b["w1"].shape
        if cin != c:
            raise ValueError(f"block {i} takes {cin} channels, gets {c}")
        if tuple(b["w2"].shape) != (9, cmid, cmid) or b["w3"].shape[0] != cmid:
            raise ValueError(f"block {i}: inconsistent w2/w3 shapes")
        cout = b["w3"].shape[1]
        if "wd" not in b and cin != cout:
            raise ValueError(f"block {i} needs a projection: {cin} -> {cout}")
        c = cout


# --------------------------------------------------------- plain versions


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 product of (rounded) operands: exact products, f32 sums."""
    return a.float() @ b.float()


def _taps(y: torch.Tensor, h: int, w: int, sign: int):
    """The 9 shifted copies of y [N, P, C] of a zero-padded 3x3, tap-major:
    sign=+1 reads pixel (y + ky - 1, x + kx - 1) (the forward), sign=-1
    reads (y - ky + 1, x - kx + 1) (the transposed conv)."""
    n, p, c = y.shape
    pad = F.pad(y.reshape(n, h, w, c), (0, 0, 1, 1, 1, 1))
    for ky in range(3):
        for kx in range(3):
            oy, ox = (ky, kx) if sign > 0 else (2 - ky, 2 - kx)
            yield pad[:, oy:oy + h, ox:ox + w, :].reshape(n, p, c)


def _block_forward(x, b, h, w, dt):
    """One block, reference rounding; returns (out, y1 (T), y2 (T))."""
    xd = x.to(dt)
    c1 = _mm(xd, b["w1"].to(dt)).to(dt)
    y1 = torch.relu(c1.float() * b["s1"] + b["b1"]).to(dt)
    w2 = b["w2"].to(dt)
    acc = None
    for t, tap in enumerate(_taps(y1, h, w, +1)):
        term = _mm(tap, w2[t])
        acc = term if acc is None else acc + term
    y2 = torch.relu(acc.to(dt).float() * b["s2"] + b["b2"]).to(dt)
    z3 = _mm(y2, b["w3"].to(dt)).to(dt).float() * b["s3"] + b["b3"]
    if "wd" in b:
        r = _mm(xd, b["wd"].to(dt)).to(dt).float() * b["sd"] + b["bd"]
    else:
        r = x
    return torch.relu(z3 + r), y1, y2


def train_stack_forward_plain(x: torch.Tensor, blocks, *, h: int, w: int,
                              dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch forward of the stack: x [N, P, Cin] f32 -> f32."""
    _check(x, blocks, h, w, dtype)
    with torch.no_grad():
        for b in blocks:
            x = _block_forward(x, b, h, w, dtype)[0]
    return x


def _wgrad(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """sum over all pixels of a[., k] * g[., n] -> [K, N] f32."""
    return _mm(a.reshape(-1, a.shape[-1]).t(), g.reshape(-1, g.shape[-1]))


def _block_backward(x, b, d_out, h, w, dt):
    """Backward of one block (the reference's hand-derived chain)."""
    out, y1, y2 = _block_forward(x, b, h, w, dt)
    xd = x.to(dt)
    d_pre = d_out * (out > 0).float()
    g3 = (d_pre * b["s3"]).to(dt)
    dws = {"w3": _wgrad(y2, g3)}
    dy2 = _mm(g3, b["w3"].to(dt).t()) * (y2 > 0).float()
    g2 = (dy2 * b["s2"]).to(dt)
    w2 = b["w2"].to(dt)
    dws["w2"] = torch.stack([_wgrad(tap, g2)
                             for tap in _taps(y1, h, w, +1)])
    dy1 = None
    for t, tap in enumerate(_taps(g2, h, w, -1)):
        term = _mm(tap, w2[t].t())
        dy1 = term if dy1 is None else dy1 + term
    g1 = (dy1 * (y1 > 0).float() * b["s1"]).to(dt)
    dws["w1"] = _wgrad(xd, g1)
    dx = _mm(g1, b["w1"].to(dt).t())
    if "wd" in b:
        gd = (d_pre * b["sd"]).to(dt)
        dws["wd"] = _wgrad(xd, gd)
        dx = dx + _mm(gd, b["wd"].to(dt).t())
    else:
        dx = dx + d_pre
    return dx, dws


def train_stack_backward_plain(x: torch.Tensor, blocks, dy: torch.Tensor, *,
                               h: int, w: int, dtype=torch.bfloat16):
    """Plain PyTorch backward: (dx [N, P, Cin] f32, [per-block dW dicts])."""
    _check(x, blocks, h, w, dtype)
    with torch.no_grad():
        xs = [x]
        for b in blocks[:-1]:
            xs.append(_block_forward(xs[-1], b, h, w, dtype)[0])
        d, dws = dy.float(), [None] * len(blocks)
        for i in range(len(blocks) - 1, -1, -1):
            d, dws[i] = _block_backward(xs[i], blocks[i], d, h, w, dtype)
    return d, dws


# ------------------------------------------------------------ CUDA kernels


def _lib():
    lib = _cuda.load("bottleneck_train")
    if lib.train_block_fwd_launch.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        sigs = {
            "train_block_fwd_launch": [p] * 16 + [i] * 7 + [p],
            "train_bwd_pre_launch": [p] * 7 + [ll, i, i, p],
            "train_bwd_dy2_launch": [p] * 5 + [i] * 3 + [p],
            "train_bwd_dy1_launch": [p] * 5 + [i] * 4 + [p],
            "train_bwd_dx_launch": [p] * 6 + [i] * 4 + [p],
            "train_wgrad_launch": [i] + [p] * 4 + [i] * 6 + [p],
            "train_block_fwd_bf16_launch": [p] * 16 + [i] * 13 + [p],
            "train_bwd_dgrad_bf16_launch": [p] * 13 + [i] * 13 + [p],
            "train_wgrad_bf16_launch": [i] * 3 + [p] * 4 + [i] * 9 + [p],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        for name, n_args in (("train_block_fwd_smem_bytes", 3),
                             ("train_mma_smem_bytes", 13),
                             ("train_wgrad_bf16_smem_bytes", 4)):
            fn = getattr(lib, name)
            fn.argtypes = [i] * n_args
            fn.restype = ll
    return lib


def _check_bf16_channels(*chans: int) -> None:
    if any(c % 8 for c in chans):
        raise ValueError(f"the bf16 train kernels take channel counts that "
                         f"are multiples of 8 (16-byte lines), got {chans}")


# M rows of a 64-channel pass: the forward's promoted sums (mma_pass
# kPromote) hold a second set of accumulators, so its passes are half
# kernel 2's; the input-gradient pass keeps kernel 2's (the C launcher
# fixes both).
_FWD_MROWS, _DGRAD_MROWS = 256, 512


def train_tile_plan(h: int, w: int, cin: int, cmid: int, cout: int,
                    n: int = 1, *, backward: bool = False) -> dict:
    """The bf16 tiling of one block of kernel 8, or (``backward=True``) of
    kernel 9's input-gradient pass, which is the same three-phase block on
    the block run backwards (g3's cout channels in, the block's cin out).
    Both kernels are kernel 2's block (``bottleneck_mma.cuh``) with their
    own epilogues and its shared memory (``mma_smem``, mirrored by
    ``ops.bottleneck._bottleneck_smem``), so kernel 2's planner
    (``bottleneck_tile_plan``) tiles them, the forward with M passes of
    half kernel 2's rows (``mrows`` in the plan)."""
    _check_bf16_channels(cin, cmid, cout)
    if backward:
        cin, cout = cout, cin
    mrows = _DGRAD_MROWS if backward else _FWD_MROWS
    return {**bottleneck_tile_plan(h, w, cin, cmid, cout, n, mrows),
            "mrows": mrows}


# Weight gradients: a 1x1's ranges are _WG_PIX pixels, a 3x3's about
# _WG_3X3_PIX pixels of whole image rows; about _WG_BLOCKS blocks share
# the ranges (3x3: one 384-thread block per SM, twice over; 1x1: 128
# threads, two or three per SM, twice over).
_WG_PIX = 128
_WG_3X3_PIX = 224
_WG_BLOCKS = {True: 264, False: 528}


def _wgrad_smem(k3: bool, knb: int, w: int, rows: int) -> int:
    """Shared memory of a weight-gradient block (``wg_smem`` in
    bottleneck_train.cu): two buffers (one range staged while the other is
    multiplied) of the A range (a 3x3's with its two halo rows, 1024-byte
    aligned) and ``knb`` 64-channel G chunks (pixels padded to 16), and a
    128-byte zero line."""
    apix = (rows + 2) * w if k3 else _WG_PIX
    gpix = -(-rows * w // 16) * 16 if k3 else _WG_PIX
    a = -(-apix * 128 // 1024) * 1024
    return 2 * (a + knb * gpix * 128) + _MMA_ZERO


def train_wgrad_plan(h: int, w: int, ka: int, ng: int, n: int,
                     taps: int) -> dict:
    """The bf16 tiling of one weight gradient dW [taps, ka, ng] = sum over
    the pixels of n [h, w] images of A^T G (``wgrad_bf16``). Blocks of
    ``grid = (slots, tiles)``: a tile is one 64-channel chunk of A by
    ``64 knb`` channels of G; a 3x3 (taps 9) range is ``rows`` image rows
    of one image, a 1x1 range ``_WG_PIX`` pixels; slot s takes ranges s, s
    + slots, ... in order. Every number depends on the shapes alone, so
    the partition, and with it dW, is the same run after run. ``part``:
    floats of the partials' workspace."""
    _check_bf16_channels(ka, ng)
    k3 = taps == 9
    if taps not in (1, 9):
        raise ValueError(f"a weight gradient has 1 or 9 taps, got {taps}")
    knb = 2 if not k3 and -(-ng // 64) % 2 == 0 else 1
    rows = 1
    if k3:
        rows = max(1, min(h, _WG_3X3_PIX // w))
        while rows > 1 and _wgrad_smem(True, 1, w, rows) > _MAX_SMEM:
            rows -= 1
        ranges = n * -(-h // rows)
    else:
        ranges = -(-n * h * w // _WG_PIX)
    smem = _wgrad_smem(k3, knb, w, rows)
    if smem > _MAX_SMEM:
        raise ValueError(f"weight-gradient tile needs {smem} B of shared "
                         f"memory (> {_MAX_SMEM}) at w={w}, one row")
    kchunks = -(-ka // 64)
    tiles = kchunks * -(-ng // (64 * knb))
    slots = min(ranges, max(1, -(-_WG_BLOCKS[k3] // tiles)))
    return {"k3": k3, "knb": knb, "rows": rows, "ranges": ranges,
            "slots": slots, "tiles": tiles, "kchunks": kchunks,
            "smem": smem, "grid": (slots, tiles),
            "part": slots * taps * ka * ng}


def _pad2(t: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """[K, N] zero-padded to [k, n]."""
    return F.pad(t, (0, n - t.shape[1], 0, k - t.shape[0]))


def _train_fwd_weights(b, plan) -> tuple:
    """Kernel 8's bf16 weights as its K loops read them: w1 and w2 as
    kernel 2's, w3 alone [coutp/NT3][cmidp/64][NT3][64] and, on an entry
    block, wd [coutp/NT3][cinp/64][NT3][64] (its own pass)."""
    w1t, w2t, w3t = _bottleneck_mma_weights(
        {k: b[k] for k in ("w1", "w2", "w3")}, plan)
    wdt = None
    if "wd" in b:
        wdt = _kmajor_tiles(_pad2(b["wd"], plan["cinp"], plan["coutp"]),
                            64 * plan["wn3"])
    return w1t, w2t, w3t, wdt


def _train_dgrad_weights(b, plan) -> tuple:
    """Kernel 9's input-gradient weights for ``train_tile_plan(...,
    backward=True)``: the block run backwards is a block with w1 = w3^T
    [cout, cmid], w2[t] = w2[8 - t]^T (the transposed 3x3 reads the
    mirrored taps, which the flip turns into the forward's reads), w3 =
    w1^T [cmid, cin] and wd = wd^T [cout, cin], relaid out as kernel 2's
    (dx's K concatenates w1^T's chunks and wd^T's)."""
    t = {"w1": b["w3"].t(), "w2": b["w2"].flip(0).transpose(1, 2),
         "w3": b["w1"].t()}
    if "wd" in b:
        t["wd"] = b["wd"].t()
    return _bottleneck_mma_weights(t, plan)


def _prep_cuda(x: torch.Tensor, blocks, dtype) -> list[dict]:
    """Weights in the compute dtype, affines f32, all contiguous on x's
    device (copies of a few hundred KB, made once per call)."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA train stack needs CUDA tensors, got "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("the CUDA train stack needs a contiguous x")
    if dtype == torch.bfloat16:
        if x.data_ptr() % 16:
            raise ValueError("the bf16 train kernels need a 16-byte aligned "
                             "x")
        for b in blocks:
            _check_bf16_channels(*b["w1"].shape, b["w3"].shape[1])
    out = []
    for b in blocks:
        pb = {}
        for k, v in b.items():
            if v.device != x.device:
                raise ValueError(f"param {k} is on {v.device}, x on "
                                 f"{x.device}")
            want = dtype if k[0] == "w" else torch.float32
            pb[k] = v.detach().to(want).contiguous()
        out.append(pb)
    return out


def _fwd_block_cuda(lib, x, b, out, y1, y2, h, w, bf16, stream):
    """One block of kernel 8: bf16 on the tensor cores, f32 on FFMA; y1
    and y2 (or None) receive the rounded conv2 and conv3 inputs."""
    n = x.shape[0]
    cin, cmid = b["w1"].shape
    cout = b["w3"].shape[1]
    ptr = _cuda.ptr
    opt = lambda t: ptr(t) if t is not None else None  # noqa: E731
    if bf16:
        plan = train_tile_plan(h, w, cin, cmid, cout, n)
        dims = (plan["cinp"], plan["cmidp"], plan["coutp"],
                plan["tile_rows"], plan["images"], plan["wn1"], plan["wn3"])
        smem = lib.train_mma_smem_bytes(h, w, cin, cmid, cout, *dims,
                                        plan["mrows"])
        if smem != plan["smem"]:
            raise RuntimeError(f"train plan and kernel 8 disagree on shared "
                               f"memory: {plan['smem']} vs {smem}")
        # Held until the launch is enqueued: a relaid-out copy freed before
        # that could hand its memory to the next allocation.
        w1t, w2t, w3t, wdt = _train_fwd_weights(b, plan)
        code = lib.train_block_fwd_bf16_launch(
            ptr(x), ptr(w1t), ptr(b["s1"]), ptr(b["b1"]), ptr(w2t),
            ptr(b["s2"]), ptr(b["b2"]), ptr(w3t), ptr(b["s3"]),
            ptr(b["b3"]), opt(wdt), opt(b.get("sd")), opt(b.get("bd")),
            ptr(out), opt(y1), opt(y2), n, h, w, cin, cmid, cout, *dims,
            stream)
        _cuda.check(code, "train_block_fwd_bf16")
        return
    tr = tile_rows(h, w)
    smem = lib.train_block_fwd_smem_bytes(w, cmid, tr)
    if smem > _MAX_SMEM:
        raise ValueError(f"train block tile needs {smem} B of shared memory "
                         f"(> {_MAX_SMEM}) at w={w}, cmid={cmid}")
    code = lib.train_block_fwd_launch(
        ptr(x), ptr(b["w1"]), ptr(b["s1"]), ptr(b["b1"]), ptr(b["w2"]),
        ptr(b["s2"]), ptr(b["b2"]), ptr(b["w3"]), ptr(b["s3"]), ptr(b["b3"]),
        opt(b.get("wd")), opt(b.get("sd")), opt(b.get("bd")), ptr(out),
        opt(y1), opt(y2), n, h, w, cin, cmid, cout, tr, stream)
    _cuda.check(code, "train_block_fwd")


def train_stack_forward_cuda(x: torch.Tensor, blocks, *, h: int, w: int,
                             dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel 8, one launch per block, on CUDA tensors."""
    _check(x, blocks, h, w, dtype)
    pblocks = _prep_cuda(x, blocks, dtype)
    lib = _lib()
    bf16 = dtype == torch.bfloat16
    stream = _cuda.stream_ptr(x.device)
    for b in pblocks:
        out = torch.empty(x.shape[0], h * w, b["w3"].shape[1],
                          dtype=torch.float32, device=x.device)
        _fwd_block_cuda(lib, x, b, out, None, None, h, w, bf16, stream)
        trace.count("launch.train_stack_forward")
        x = out
    return x


def _dgrad_bf16(lib, b, g3, gd, dpre, y1, y2, g2, g1, dx, h, w, stream):
    """Kernel 9's input-gradient pass of one block in bf16: g2, g1 (into
    the given buffers) and dx in one launch."""
    n = g3.shape[0]
    cin, cmid = b["w1"].shape
    cout = b["w3"].shape[1]
    plan = train_tile_plan(h, w, cin, cmid, cout, n, backward=True)
    tiles = (plan["tile_rows"], plan["images"], plan["wn1"], plan["wn3"])
    smem = lib.train_mma_smem_bytes(h, w, cout, cmid, cin, plan["cinp"],
                                    plan["cmidp"], plan["coutp"], *tiles,
                                    plan["mrows"])
    if smem != plan["smem"]:
        raise RuntimeError(f"train plan and kernel 9 disagree on shared "
                           f"memory: {plan['smem']} vs {smem}")
    wa, wb, wc = _train_dgrad_weights(b, plan)  # held until enqueued
    ptr = _cuda.ptr
    opt = lambda t: ptr(t) if t is not None else None  # noqa: E731
    code = lib.train_bwd_dgrad_bf16_launch(
        ptr(g3), opt(gd), ptr(wa), ptr(wb), ptr(wc), ptr(y1), ptr(y2),
        ptr(b["s1"]), ptr(b["s2"]), opt(dpre), ptr(g2), ptr(g1), ptr(dx),
        n, h, w, cin, cmid, cout, plan["coutp"], plan["cmidp"],
        plan["cinp"], *tiles, stream)
    _cuda.check(code, "train_bwd_dgrad_bf16")


def _wgrad_bf16(lib, a, g, part, dw, h, w, ka, ng, taps, stream):
    """One weight gradient in bf16 (``train_wgrad_plan``); ``a`` is the
    f32 block input (rounded as it is staged) or a bf16 activation."""
    n = a.shape[0]
    plan = train_wgrad_plan(h, w, ka, ng, n, taps)
    smem = lib.train_wgrad_bf16_smem_bytes(int(plan["k3"]), plan["knb"], w,
                                           plan["rows"])
    if smem != plan["smem"]:
        raise RuntimeError(f"wgrad plan and kernel disagree on shared "
                           f"memory: {plan['smem']} vs {smem}")
    if part.numel() < plan["part"]:
        raise ValueError(f"wgrad workspace of {part.numel()} floats < "
                         f"{plan['part']}")
    code = lib.train_wgrad_bf16_launch(
        int(plan["k3"]), plan["knb"], int(a.dtype == torch.float32),
        _cuda.ptr(a), _cuda.ptr(g), _cuda.ptr(part), _cuda.ptr(dw), n, h, w,
        ka, ng, plan["rows"], plan["ranges"], plan["slots"], plan["tiles"],
        stream)
    _cuda.check(code, "train_wgrad_bf16")


def train_stack_backward_cuda(x: torch.Tensor, blocks, dy: torch.Tensor, *,
                              h: int, w: int, dtype=torch.bfloat16):
    """Kernel 9 on CUDA tensors: (dx f32, [per-block f32 dW dicts]). Per
    block, in reverse: bwd_pre, the input gradient (bf16: one launch; f32:
    dy2, dy1, dx), then the weight gradients in the order w3, w2, w1
    (, wd)."""
    _check(x, blocks, h, w, dtype)
    if dy.shape[:2] != x.shape[:2] or dy.dtype != torch.float32:
        raise ValueError(f"dy must be f32 [N, P, Cout], got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    pblocks = _prep_cuda(x, blocks, dtype)
    lib = _lib()
    bf16 = dtype == torch.bfloat16
    stream = _cuda.stream_ptr(x.device)
    dev, n, p = x.device, x.shape[0], h * w
    rows = n * p
    ptr = _cuda.ptr
    opt = lambda t: ptr(t) if t is not None else None  # noqa: E731

    def empty(c, dt=dtype):
        return torch.empty(n, p, c, dtype=dt, device=dev)

    # 1. recompute: every block's input and output, y1 and y2.
    xs, y1s, y2s = [x], [], []
    for b in pblocks:
        cmid, cout = b["w3"].shape
        out, y1, y2 = empty(cout, torch.float32), empty(cmid), empty(cmid)
        _fwd_block_cuda(lib, xs[-1], b, out, y1, y2, h, w, bf16, stream)
        xs.append(out)
        y1s.append(y1)
        y2s.append(y2)
    d = dy.contiguous()
    dws = [None] * len(pblocks)
    for i in range(len(pblocks) - 1, -1, -1):
        b, xb = pblocks[i], xs[i]
        cin, cmid = b["w1"].shape
        cout = b["w3"].shape[1]
        proj = "wd" in b
        # 2. d_pre, g3, gd
        g3 = empty(cout)
        gd = empty(cout) if proj else None
        dpre = None if proj else empty(cout, torch.float32)
        _cuda.check(lib.train_bwd_pre_launch(
            ptr(xs[i + 1]), ptr(d), ptr(b["s3"]), opt(b.get("sd")),
            opt(dpre), ptr(g3), opt(gd), rows, cout, int(bf16), stream),
            "train_bwd_pre")
        # 3.-5. g2, g1 (the transposed 3x3) and dx
        g2, g1 = empty(cmid), empty(cmid)
        dx = empty(cin, torch.float32)
        if bf16:
            _dgrad_bf16(lib, b, g3, gd, dpre, y1s[i], y2s[i], g2, g1, dx, h,
                        w, stream)
        else:
            _cuda.check(lib.train_bwd_dy2_launch(
                ptr(g3), ptr(b["w3"]), ptr(y2s[i]), ptr(b["s2"]), ptr(g2),
                rows, cmid, cout, stream), "train_bwd_dy2")
            _cuda.check(lib.train_bwd_dy1_launch(
                ptr(g2), ptr(b["w2"]), ptr(y1s[i]), ptr(b["s1"]), ptr(g1), n,
                h, w, cmid, stream), "train_bwd_dy1")
            _cuda.check(lib.train_bwd_dx_launch(
                ptr(g1), ptr(b["w1"]), opt(gd), opt(b.get("wd")), opt(dpre),
                ptr(dx), rows, cin, cmid, cout, stream), "train_bwd_dx")
        # 6. dW: partials over a fixed partition, summed in a fixed order.
        jobs = [("w3", 0, y2s[i], g3, cmid, cout, 1),
                ("w2", 2, y1s[i], g2, cmid, cmid, 9),
                ("w1", 1, xb, g1, cin, cmid, 1)]
        if proj:
            jobs.append(("wd", 1, xb, gd, cin, cout, 1))
        if bf16:
            size = max(train_wgrad_plan(h, w, k, c, n, t)["part"]
                       for *_, k, c, t in jobs)
        else:
            size = max(n * t * k * c for *_, k, c, t in jobs)
        part = torch.empty(size, dtype=torch.float32, device=dev)
        dws[i] = {}
        for name, amode, a, g, k, c, taps in jobs:
            dw = torch.empty((taps, k, c) if taps > 1 else (k, c),
                             dtype=torch.float32, device=dev)
            if bf16:
                _wgrad_bf16(lib, a, g, part, dw, h, w, k, c, taps, stream)
            else:
                _cuda.check(lib.train_wgrad_launch(
                    amode, ptr(a), ptr(g), ptr(part), ptr(dw), n, h, w, k, c,
                    taps, stream), "train_wgrad")
            dws[i][name] = dw
        trace.count("launch.train_stack_backward")
        d = dx
    return d, dws


# --------------------------------------------------------------- dispatch


def train_stack_forward(x: torch.Tensor, blocks, *, h: int, w: int,
                        dtype=torch.bfloat16) -> torch.Tensor:
    """Forward of the stack: kernel 8 on a CUDA tensor, the plain version
    on a CPU tensor."""
    if x.device.type == "cuda":
        return train_stack_forward_cuda(x, blocks, h=h, w=w, dtype=dtype)
    if x.device.type == "cpu":
        return train_stack_forward_plain(x, blocks, h=h, w=w, dtype=dtype)
    raise ValueError(f"train_stack_forward: unsupported device {x.device}")


def train_stack_backward(x: torch.Tensor, blocks, dy: torch.Tensor, *,
                         h: int, w: int, dtype=torch.bfloat16):
    """Backward of the stack: kernel 9 on a CUDA tensor, the plain version
    on a CPU tensor."""
    if x.device.type == "cuda":
        return train_stack_backward_cuda(x, blocks, dy, h=h, w=w,
                                         dtype=dtype)
    if x.device.type == "cpu":
        return train_stack_backward_plain(x, blocks, dy, h=h, w=w,
                                          dtype=dtype)
    raise ValueError(f"train_stack_backward: unsupported device {x.device}")


def _flatten(blocks) -> tuple[tuple, list[torch.Tensor]]:
    layout, flat = [], []
    for b in blocks:
        keys = _BLOCK_KEYS + (_PROJ_KEYS if "wd" in b else ())
        layout.append(keys)
        flat += [b[k] for k in keys]
    return tuple(layout), flat


def _unflatten(layout, flat) -> list[dict]:
    blocks, i = [], 0
    for keys in layout:
        blocks.append(dict(zip(keys, flat[i:i + len(keys)])))
        i += len(keys)
    return blocks


class BottleneckStackTrain(torch.autograd.Function):
    """The stack as one differentiable op. Saves only the stack input (and
    the weights it was given); the backward recomputes the chain."""

    @staticmethod
    def forward(ctx, x, spec, *flat):
        layout, h, w, dtype = spec
        ctx.spec = spec
        ctx.save_for_backward(x, *flat)
        return train_stack_forward(x, _unflatten(layout, flat), h=h, w=w,
                                   dtype=dtype)

    @staticmethod
    def backward(ctx, dy):
        layout, h, w, dtype = ctx.spec
        x, *flat = ctx.saved_tensors
        dx, dws = train_stack_backward(x, _unflatten(layout, flat),
                                       dy.contiguous(), h=h, w=w,
                                       dtype=dtype)
        grads = []
        for keys, dw in zip(layout, dws):
            grads += [dw[k] if k in dw else None for k in keys]
        return (dx, None, *grads)


def bottleneck_stack_train(x: torch.Tensor,
                           blocks: Sequence[Mapping[str, torch.Tensor]], *,
                           h: int, w: int,
                           dtype=torch.bfloat16) -> torch.Tensor:
    """[N, H*W, Cin] f32 -> [N, H*W, Cout] f32 through the frozen-BN stack,
    differentiable in x and every conv kernel (w1, w2, w3, wd)."""
    layout, flat = _flatten(blocks)
    return BottleneckStackTrain.apply(x, (layout, h, w, dtype), *flat)
