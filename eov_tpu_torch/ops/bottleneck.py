"""Fused stride-1 ResNet block stacks (kernels 2, 4 and 5 of the port).

Counterpart of ``eov_tpu/ops/pallas_bottleneck.py``, with its grouping:

* ``pack_bottleneck_params`` / ``fused_bottleneck_stack`` (kernel 2): a
  stack of stride-1 bottleneck blocks (a projection shortcut allowed on the
  first) over activations flattened to ``[N, H*W, C]`` (NHWC memory, i.e. a
  channels_last map). The CUDA kernel (``csrc/bottleneck_stack.cu``) fuses
  each block's three convs, biases, residual and ReLUs so the block's
  intermediate maps never reach device memory; the wrapper launches it once
  per block.
* ``fused_pool_bottleneck_stack`` (kernel 5): the stem's 3x3/s2 max-pool
  and that stack, from the pre-pool map ``[N, 2H, 2W, C]``. The first block
  goes through kernel 2's code with the pool building its staged input
  (same file), the others through kernel 2; the result equals
  ``maxpool_3x3_s2_nonneg`` then ``fused_bottleneck_stack`` in value.
  Both run bf16 on the tensor cores (``wgmma``, tiles planned by
  ``bottleneck_tile_plan``) and f32 on FFMA.
* ``pack_basic_params`` / ``fused_basic_stack`` (kernel 4,
  ``csrc/basic_stack.cu``): a stack of stride-1 basic blocks (resnet18/34)
  with C constant, one fused block per launch; bf16 on the tensor cores
  (``wgmma``, tiles planned by ``basic_tile_plan``), f32 on FFMA.

Rounding follows the reference chains: f32 accumulation; in a bottleneck
block (``_run_chain``) y1 and y2 round to the compute dtype after
bias+ReLU and ``y3 + b3 + residual`` is summed in f32 before the last ReLU
and one rounding; in a basic block (``_run_basic_chain``) y1 rounds after
bias+ReLU and ``a2 + b2 + x`` is summed in f32 before the ReLU and one
rounding. The plain PyTorch versions below compute exactly that and are the
kernels' oracles. Each ``fused_*`` function picks by the tensor's device and
counts its kernel launches in ``utils.trace`` (``launch.<function>``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F

from eov_tpu_torch.ops import _cuda
from eov_tpu_torch.ops.pool import maxpool_plain
from eov_tpu_torch.utils import trace

__all__ = ["pack_bottleneck_params", "fused_bottleneck_stack",
           "bottleneck_stack_plain", "bottleneck_stack_cuda",
           "stack_flops_per_img", "fused_pool_bottleneck_stack",
           "pool_bottleneck_stack_plain", "pool_bottleneck_stack_cuda",
           "pack_basic_params", "fused_basic_stack", "basic_stack_plain",
           "basic_stack_cuda", "basic_tile_rows", "basic_tile_plan",
           "bottleneck_tile_plan", "bf16_ulp"]

_DTYPES = (torch.float32, torch.bfloat16)
_WEIGHTS = ("w1", "w2", "w3", "wd")
_MAX_SMEM = 232448  # bytes of shared memory a block may use on Hopper
# Kernel 4's tile budget: two blocks per SM (228 KB of shared memory per SM,
# 1 KB of it reserved per block), and at most four 128-pixel GEMM tiles.
_TWO_PER_SM_SMEM = 112 * 1024
_BASIC_TILE_PX = 512


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


def _check_x(x: torch.Tensor, h: int, w: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"expected x [N, H*W, C], got {tuple(x.shape)}")
    if x.shape[1] != h * w:
        raise ValueError(f"x rows {x.shape[1]} != h*w {h * w}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"compute dtype must be one of {_DTYPES}")


def _check(x: torch.Tensor, blocks, h: int, w: int) -> None:
    _check_x(x, h, w)
    _check_blocks(blocks, x.shape[2])


def _check_blocks(blocks, c: int) -> None:
    if not blocks:
        raise ValueError("empty block stack")
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


def _conv3x3(x: torch.Tensor, w9: torch.Tensor, h: int,
             w: int) -> torch.Tensor:
    """[N, H*W, Cin] -> f32 [N, H*W, Cout]: a zero-padded 3x3 as nine
    shifted matmuls (tap-major ky*3+kx weights), as in the reference. The
    matmuls run in f32 on f32-widened operands (exact products of bf16
    values); on a GPU the caller keeps TF32 off."""
    n, _, cin = x.shape
    pad = F.pad(x.reshape(n, h, w, cin), (0, 0, 1, 1, 1, 1))
    w9 = w9.float()
    acc = torch.zeros(n, h * w, w9.shape[-1], device=x.device)
    for ky in range(3):
        for kx in range(3):
            tap = pad[:, ky:ky + h, kx:kx + w, :].reshape(n, h * w, cin)
            acc = acc + tap.float() @ w9[ky * 3 + kx]
    return acc


def bottleneck_stack_plain(x: torch.Tensor, blocks, *, h: int, w: int,
                           stream_max: bool = False):
    """Plain PyTorch version of the stack (the kernel's oracle).

    ``stream_max=True`` also returns, broadcast over the output's channels,
    the magnitude the stream carries at each pixel: the largest |x| over
    the pixel's channels over the stack's input and every block's output
    (``basic_stack_plain``'s measure, for ``bf16_ulp``)."""
    _check(x, blocks, h, w)
    dt = x.dtype
    top = x.float().abs().amax(dim=-1, keepdim=True)
    for b in blocks:
        xf = x.float()
        y1 = torch.relu(xf @ b["w1"].float() + _bias(b["b1"])).to(dt)
        y2 = torch.relu(_conv3x3(y1, b["w2"], h, w) + _bias(b["b2"])).to(dt)
        y3 = y2.float() @ b["w3"].float() + _bias(b["b3"])
        res = xf @ b["wd"].float() + _bias(b["bd"]) if "wd" in b else xf
        x = torch.relu(y3 + res).to(dt)
        if stream_max:
            top = torch.maximum(top, x.float().abs().amax(dim=-1,
                                                          keepdim=True))
    return (x, top.expand(x.shape)) if stream_max else x


def _lib():
    lib = _cuda.load("bottleneck_stack")
    if lib.bottleneck_block_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.bottleneck_block_launch,
                   lib.pool_bottleneck_block_launch):
            fn.argtypes = [p] * 10 + [i] * 7 + [p]
            fn.restype = ctypes.c_int
        for fn in (lib.bottleneck_block_bf16_launch,
                   lib.pool_bottleneck_block_bf16_launch):
            fn.argtypes = [p] * 9 + [i] * 15 + [p]
            fn.restype = ctypes.c_int
        lib.bottleneck_block_smem_bytes.argtypes = [i] * 3
        lib.bottleneck_block_bf16_smem_bytes.argtypes = [i] * 12
        for fn in (lib.bottleneck_block_smem_bytes,
                   lib.bottleneck_block_bf16_smem_bytes):
            fn.restype = ctypes.c_longlong
    return lib


def tile_rows(h: int, w: int) -> int:
    """Output rows per thread block of the f32 kernel: as many as fit a
    128-pixel tile."""
    if w > 128:
        raise ValueError(f"map width {w} > 128 is not supported by the "
                         "bottleneck kernel's 128-pixel tiles")
    return max(1, min(h, 128 // w))


def _bottleneck_smem(h: int, w: int, cinp: int, cmidp: int, tr: int, g: int,
                     wn1: int, wn3: int, mrows: int = 512) -> int:
    """Shared memory of a bf16 kernel-2 block (``mma_smem`` in
    bottleneck_stack.cu): the weight ring, one or two staged 64-channel x
    chunks of the block's rows and halo, y1 over them at all of cmid's
    channels, and y2 unless it takes y1's place (phase B one M pass and one
    N pass)."""
    yrows = min(tr + 2, h)
    ring = 64 * 64 * 2 * max(wn1, wn3)
    xbuf = g * yrows * w * 128
    y1 = g * yrows * w * cmidp * 2
    overlay = cmidp == 64 * wn1 and g * tr * w <= mrows // wn1
    y2 = 0 if overlay else g * tr * w * cmidp * 2
    return _MMA_ZERO + _MMA_STAGES * ring + (2 if cinp > 64 else 1) * xbuf \
        + y1 + y2


def bottleneck_tile_plan(h: int, w: int, cin: int, cmid: int, cout: int,
                         n: int = 1, mrows: int = 512) -> dict:
    """The bf16 kernel's tiling of one block over an [n, h*w, cin] map.

    Channels are padded to multiples of 64 (``cinp``, ``cmidp``,
    ``coutp``). conv1 and conv2 run in N passes of ``64 wn1`` channels and
    M passes of ``m_tile = mrows / wn1`` pixels, conv3 in passes of ``64
    wn3`` and ``m_tile_out = mrows / wn3`` (``mrows`` 512: the block's 8
    warps hold 64 x 64 products each; 256: half of that, as the train
    forward's promoted sums need twice the registers). Of the tile heights (``tile_rows``; with the whole map,
    ``images`` maps per block, at most ``n``) and pass widths whose block
    fits the shared memory, the plan takes the one with the fewest K steps
    (one 64-deep product of a whole M x N pass and one barrier) per image,
    then the fewest blocks: a step costs the same however few of its rows
    are in the image. Returns those, ``overlay`` (y2 in y1's place),
    ``smem``, ``steps`` per image and the launch ``grid`` (row tiles, image
    groups). The search is cached per shape: it takes about a millisecond
    of host time, more than a small launch's device time."""
    return dict(_tile_plan(h, w, cin, cmid, cout, n, mrows))


@functools.lru_cache(maxsize=256)
def _tile_plan(h: int, w: int, cin: int, cmid: int, cout: int,
               n: int, mrows: int) -> dict:
    """``bottleneck_tile_plan``, searched once per shape."""
    cinp, cmidp, coutp = (-(-c // 64) * 64 for c in (cin, cmid, cout))
    kin, kmid, kout = cinp // 64, cmidp // 64, coutp // 64
    kc = kmid + (kin if cin != cout else 0)  # conv3's K chunks

    def steps(tr, g, wn1, wn3):
        mt1, mt3 = mrows // wn1, mrows // wn3
        total = 0
        for r0 in range(0, h, tr):
            rows = min(tr, h - r0)
            ra = min(r0 + rows + 1, h) - max(r0 - 1, 0)
            mb = g * rows * w
            total += (-(-g * ra * w // mt1) * (kmid // wn1) * kin
                      + -(-mb // mt1) * (kmid // wn1) * kmid * 9
                      + -(-mb // mt3) * (kout // wn3) * kc)
        return total

    best = None
    for wn1 in (v for v in (1, 2, 4) if kmid % v == 0):
        for wn3 in (v for v in (1, 2, 4) if kout % v == 0):
            for tr in range(1, h + 1):
                for g in range(1, (n if tr == h else 1) + 1):
                    smem = _bottleneck_smem(h, w, cinp, cmidp, tr, g, wn1,
                                            wn3, mrows)
                    if smem > _MAX_SMEM:
                        break
                    key = (steps(tr, g, wn1, wn3) / g, -tr * g, smem)
                    if best is None or key < best[0]:
                        best = (key, tr, g, wn1, wn3)
    if best is None:
        least = _bottleneck_smem(h, w, cinp, cmidp, 1, 1, 1, 1)
        raise ValueError(f"bottleneck tile needs {least} B of shared memory "
                         f"(> {_MAX_SMEM}) at w={w}, cin={cin}, cmid={cmid}, "
                         f"one row")
    (per_img, _, smem), tr, g, wn1, wn3 = best
    return {"tile_rows": tr, "images": g, "cinp": cinp, "cmidp": cmidp,
            "coutp": coutp, "wn1": wn1, "wn3": wn3, "m_tile": mrows // wn1,
            "m_tile_out": mrows // wn3,
            "overlay": cmidp == 64 * wn1 and g * tr * w <= mrows // wn1,
            "smem": smem, "steps": per_img,
            "grid": (-(-h // tr), -(-n // g))}


def _kmajor_tiles(wk: torch.Tensor, nt: int) -> torch.Tensor:
    """[K, N] (multiples of 64 and nt) -> [N/nt, K/64, nt, 64]: each (N
    pass, 64-deep K chunk) tile contiguous and K-major."""
    k, n = wk.shape
    return wk.reshape(k // 64, 64, n // nt, nt).permute(2, 0, 3, 1) \
        .contiguous()


def _bottleneck_mma_weights(b, plan) -> tuple:
    """A packed block's weights as the bf16 kernel's K loops read them,
    zero-padded: w1 [cmidp/NT1][cinp/64][NT1][64], w2 [cmidp/NT1][cmidp/64]
    [9][NT1][64], and w3 with (on an entry block) wd's rows after its own,
    [coutp/NT3][cmidp/64 (+ cinp/64)][NT3][64]."""
    cin, cmid = b["w1"].shape
    cout = b["w3"].shape[1]
    cinp, cmidp, coutp = plan["cinp"], plan["cmidp"], plan["coutp"]
    nt1, nt3 = 64 * plan["wn1"], 64 * plan["wn3"]
    w1 = F.pad(b["w1"], (0, cmidp - cmid, 0, cinp - cin))
    w3 = F.pad(b["w3"], (0, coutp - cout, 0, cmidp - cmid))
    if "wd" in b:
        w3 = torch.cat([w3, F.pad(b["wd"], (0, coutp - cout, 0, cinp - cin))])
    return (_kmajor_tiles(w1, nt1), _mma_weights(b["w2"], cmidp, nt1),
            _kmajor_tiles(w3, nt3))


def _check_cuda(x: torch.Tensor, blocks, name: str) -> None:
    """A contiguous CUDA x; weights packed in x's dtype and f32 biases, all
    contiguous on x's device."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous x")
    for b in blocks:
        for k, v in b.items():
            want = x.dtype if k in _WEIGHTS else torch.float32
            if v.dtype != want or v.device != x.device or \
                    not v.is_contiguous():
                raise ValueError(f"param {k} must be a contiguous {want} "
                                 f"tensor on {x.device}")


def _launch_block(x, b, out, *, h: int, w: int, pool: bool) -> None:
    """One bottleneck block through kernel 2 (or kernel 5's pool entry):
    bf16 on the tensor cores, f32 on the FFMA kernel."""
    lib = _lib()
    cin, cmid = b["w1"].shape
    cout = b["w3"].shape[1]
    proj = "wd" in b
    n = x.shape[0]
    stream = _cuda.stream_ptr(x.device)
    if x.dtype == torch.bfloat16:
        if pool and cin > 64:
            raise ValueError(f"kernel 5 in bf16 pools one staged chunk of at "
                             f"most 64 channels (the stem's), got {cin}; run "
                             f"maxpool_3x3_s2_nonneg then "
                             f"fused_bottleneck_stack")
        plan = bottleneck_tile_plan(h, w, cin, cmid, cout, n)
        dims = (n, h, w, cin, cmid, cout, plan["cinp"], plan["cmidp"],
                plan["coutp"], plan["tile_rows"], plan["images"],
                plan["wn1"], plan["wn3"])
        smem = lib.bottleneck_block_bf16_smem_bytes(*dims[1:])
        if smem != plan["smem"]:
            raise RuntimeError(f"bottleneck plan and kernel disagree on "
                               f"shared memory: {plan['smem']} vs {smem}")
        # Held until the launch is enqueued: a relaid-out copy freed before
        # that could hand its memory to the next allocation.
        w1t, w2t, w3t = _bottleneck_mma_weights(b, plan)
        vec = int(cin % 8 == 0 and cout % 8 == 0 and x.data_ptr() % 16 == 0)
        fn = lib.pool_bottleneck_block_bf16_launch if pool else \
            lib.bottleneck_block_bf16_launch
        code = fn(_cuda.ptr(x), _cuda.ptr(w1t), _cuda.ptr(b["b1"]),
                  _cuda.ptr(w2t), _cuda.ptr(b["b2"]), _cuda.ptr(w3t),
                  _cuda.ptr(b["b3"]), _cuda.ptr(b["bd"]) if proj else None,
                  _cuda.ptr(out), *dims, int(proj), vec, stream)
        _cuda.check(code, "bottleneck_stack")
        return
    tr = tile_rows(h, w)
    smem = lib.bottleneck_block_smem_bytes(w, cmid, tr)
    if smem > _MAX_SMEM:
        raise ValueError(f"bottleneck tile needs {smem} B of shared "
                         f"memory (> {_MAX_SMEM}) at w={w}, cmid={cmid}")
    fn = lib.pool_bottleneck_block_launch if pool else \
        lib.bottleneck_block_launch
    code = fn(
        _cuda.ptr(x), _cuda.ptr(b["w1"]), _cuda.ptr(b["b1"]),
        _cuda.ptr(b["w2"]), _cuda.ptr(b["b2"]), _cuda.ptr(b["w3"]),
        _cuda.ptr(b["b3"]),
        _cuda.ptr(b["wd"]) if proj else None,
        _cuda.ptr(b["bd"]) if proj else None,
        _cuda.ptr(out), n, h, w, cin, cmid, cout, tr, stream,
    )
    _cuda.check(code, "bottleneck_stack")


def bottleneck_stack_cuda(x: torch.Tensor, blocks, *, h: int,
                          w: int) -> torch.Tensor:
    """The CUDA kernel, one launch per block, on CUDA tensors.

    Weights must already be packed in x's dtype (``pack_bottleneck_params``)
    and biases f32, all contiguous on x's device.
    """
    _check(x, blocks, h, w)
    _check_cuda(x, blocks, "bottleneck_stack_cuda")
    for b in blocks:
        out = torch.empty(x.shape[0], h * w, b["w3"].shape[1],
                          dtype=x.dtype, device=x.device)
        _launch_block(x, b, out, h=h, w=w, pool=False)
        trace.count("launch.fused_bottleneck_stack")
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


# ------------------------------------------- kernel 5: pool + bottleneck


def _pooled_hw(x: torch.Tensor) -> tuple[int, int]:
    if x.dim() != 4:
        raise ValueError(f"expected the pre-pool map [N, 2H, 2W, C], got "
                         f"{tuple(x.shape)}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"even H/W required, got {x.shape[1]}x{x.shape[2]}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"compute dtype must be one of {_DTYPES}")
    return x.shape[1] // 2, x.shape[2] // 2


def pool_bottleneck_stack_plain(x: torch.Tensor, blocks) -> torch.Tensor:
    """Plain version of kernel 5: the zero-padded 3x3/s2 max-pool (exact on
    input >= 0), then the plain bottleneck stack."""
    h, w = _pooled_hw(x)
    pooled = maxpool_plain(x)
    return bottleneck_stack_plain(pooled.reshape(x.shape[0], h * w, -1),
                                  blocks, h=h, w=w)


def pool_bottleneck_stack_cuda(x: torch.Tensor, blocks) -> torch.Tensor:
    """Kernel 5: the first block builds its pooled input itself (one
    launch; in bf16 at most 64 input channels, the stem's), the others run
    on kernel 2."""
    h, w = _pooled_hw(x)
    _check_blocks(blocks, x.shape[3])
    _check_cuda(x, blocks, "pool_bottleneck_stack_cuda")
    b = blocks[0]
    out = torch.empty(x.shape[0], h * w, b["w3"].shape[1], dtype=x.dtype,
                      device=x.device)
    _launch_block(x, b, out, h=h, w=w, pool=True)
    trace.count("launch.fused_pool_bottleneck_stack")
    if len(blocks) > 1:
        out = bottleneck_stack_cuda(out, blocks[1:], h=h, w=w)
    return out


def fused_pool_bottleneck_stack(x: torch.Tensor, blocks) -> torch.Tensor:
    """Pre-pool NHWC map [N, 2H, 2W, Cin] (>= 0) -> [N, H*W, Cout]: the
    stem max-pool and the stride-1 bottleneck stack; kernel 5 on a CUDA
    tensor, the plain version on a CPU tensor."""
    kind = x.device.type
    if kind == "cuda":
        return pool_bottleneck_stack_cuda(x, blocks)
    if kind == "cpu":
        return pool_bottleneck_stack_plain(x, blocks)
    raise ValueError(f"fused_pool_bottleneck_stack: unsupported device "
                     f"{x.device}")


# --------------------------------------------- kernel 4: basic-block stack

_BASIC_KEYS = ("w1", "b1", "w2", "b2")


def pack_basic_params(block: Mapping[str, Mapping[str, torch.Tensor]],
                      dtype=torch.float32) -> dict:
    """A folded basic block (``conv1``, ``conv2``: ``{"weight": OIHW,
    "bias": [C]}``) -> the kernel's arrays: both 3x3 weights as
    ``[9, C, C]`` tap-major (ky*3+kx) in ``dtype``, biases f32. Stride-1,
    projection-free blocks with Cin == Cout only (every non-entry basic
    block, and all of stage 1)."""
    if "downsample" in block:
        raise ValueError("fused basic stack: projection (stage-entry) blocks "
                         "stay on cuDNN")
    w1, w2 = block["conv1"]["weight"], block["conv2"]["weight"]
    if w1.shape[0] != w1.shape[1]:
        raise ValueError("fused basic stack requires Cin == Cout (stride-1 "
                         f"tail blocks), got conv1 {tuple(w1.shape)}")

    def taps(wt):
        return wt.permute(2, 3, 1, 0).reshape(9, wt.shape[1], wt.shape[0]) \
                 .to(dtype).contiguous()

    return {"w1": taps(w1), "b1": block["conv1"]["bias"].float().contiguous(),
            "w2": taps(w2), "b2": block["conv2"]["bias"].float().contiguous()}


def _check_basic(x: torch.Tensor, blocks, h: int, w: int) -> None:
    _check_x(x, h, w)
    if not blocks:
        raise ValueError("empty block stack")
    c = x.shape[2]
    for i, b in enumerate(blocks):
        stray = [k for k in b if k not in _BASIC_KEYS]
        if stray:
            raise KeyError(f"basic-block stack got non-basic params {stray} "
                           "(a basic block has w1, b1, w2, b2 only)")
        missing = [k for k in _BASIC_KEYS if k not in b]
        if missing:
            raise KeyError(f"block {i} is missing kernel params {missing}")
        if tuple(b["w1"].shape) != (9, c, c) or \
                tuple(b["w2"].shape) != (9, c, c):
            raise ValueError(f"fused basic stack: constant channel count "
                             f"required, got {c} vs block {i} "
                             f"{tuple(b['w1'].shape)}")


def basic_stack_plain(x: torch.Tensor, blocks, *, h: int, w: int,
                      stream_max: bool = False):
    """Plain PyTorch version of the basic stack (kernel 4's oracle).

    ``stream_max=True`` also returns the magnitude the residual stream
    carries at each element: the largest |x| at its pixel (over the
    channels) over the stack (each block's input and the output), in f32,
    broadcast over the channels. A rounding flip anywhere in a pixel's
    3x3 x C products moves every channel there by ulps of that magnitude,
    so an error is measured in its ulps; a ReLU knife edge, where the
    stream is 0 in one channel at every block, then has a finite one."""
    _check_basic(x, blocks, h, w)
    dt = x.dtype
    top = x.float().abs().amax(dim=-1, keepdim=True)
    for b in blocks:
        y1 = torch.relu(_conv3x3(x, b["w1"], h, w) + _bias(b["b1"])).to(dt)
        x = torch.relu(_conv3x3(y1, b["w2"], h, w) + _bias(b["b2"])
                       + x.float()).to(dt)
        if stream_max:
            top = torch.maximum(top, x.float().abs().amax(dim=-1,
                                                          keepdim=True))
    return (x, top.expand(x.shape)) if stream_max else x


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The bf16 ulp at magnitude |v| (2^(floor(log2 |v|) - 7); that of the
    smallest normal below it), in f32."""
    _, e = torch.frexp(v.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32),
                       (e - 8).to(torch.float32))


def _basic_lib():
    lib = _cuda.load("basic_stack")
    if lib.basic_block_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.basic_block_launch.argtypes = [p] * 6 + [i] * 5 + [p]
        lib.basic_block_bf16_launch.argtypes = [p] * 6 + [i] * 9 + [p]
        for fn in (lib.basic_block_launch, lib.basic_block_bf16_launch):
            fn.restype = ctypes.c_int
        lib.basic_block_smem_bytes.argtypes = [i] * 3
        lib.basic_block_bf16_smem_bytes.argtypes = [i] * 7
        for fn in (lib.basic_block_smem_bytes,
                   lib.basic_block_bf16_smem_bytes):
            fn.restype = ctypes.c_longlong
    return lib


def basic_tile_rows(smem_bytes, h: int, w: int) -> int:
    """Kernel 4's output rows per thread block in f32. ``smem_bytes(tr)``
    is the tile's shared memory. The most rows that keep the tile within
    ``_BASIC_TILE_PX`` output pixels and two blocks per SM, then evened out
    over the tiles (the conv1 halo is recomputed per tile, so taller tiles
    waste less); one row if even that exceeds the two-per-SM budget."""
    tr = 1
    while tr < h and (tr + 1) * w <= _BASIC_TILE_PX and \
            smem_bytes(tr + 1) <= _TWO_PER_SM_SMEM:
        tr += 1
    tiles = -(-h // tr)
    return -(-h // tiles)


# The bf16 kernel's block: two warpgroups, 64 pixels x 64 channels of
# products per warp, a ring of three [NT, 64] weight tiles, a 128-byte zero
# line.
_MMA_WARPS = 8
_MMA_STAGES = 3
_MMA_ZERO = 128


def _mma_smem(h: int, w: int, cp: int, wn: int, tr: int, g: int) -> int:
    """Shared memory of a bf16 block (``mma_smem`` in basic_stack.cu): the
    weight ring, one or two staged 64-channel x chunks of the block's rows
    and halo, and y1 over its rows and halo at all channels."""
    ring = 64 * 64 * wn * 2
    xbuf = g * min(tr + 4, h) * w * 64 * 2
    y1 = g * min(tr + 2, h) * w * cp * 2
    return _MMA_ZERO + _MMA_STAGES * ring + (2 if cp > 64 else 1) * xbuf + y1


def basic_tile_plan(h: int, w: int, c: int, n: int = 1) -> dict:
    """The bf16 kernel's tiling of an [n, h*w, c] map: channels padded to
    ``cp`` (a multiple of 64), ``NT = 64 wn`` output channels a pass
    (dividing ``cp``) and ``m_tile = 512 / wn`` pixels (the block's 8 warps
    hold 64 x 64 products each). Tile rows: the most whose y1 rows (with
    the halo) fill one M pass within the shared memory, evened out over
    the tiles; when the whole map fits, ``images`` maps per block (at most
    ``n``). Returns ``tile_rows``, ``images``, ``cp``, ``wn``, ``m_tile``,
    ``smem`` and the launch ``grid`` (row tiles, image groups)."""
    cp = -(-c // 64) * 64
    chunks = cp // 64
    wn = 4 if chunks % 4 == 0 else 2 if chunks % 2 == 0 else 1
    m_tile = _MMA_WARPS // wn * 64

    def smem(tr, g=1):
        return _mma_smem(h, w, cp, wn, tr, g)

    if smem(1) > _MAX_SMEM:
        raise ValueError(f"basic-block tile needs {smem(1)} B of shared "
                         f"memory (> {_MAX_SMEM}) at w={w}, c={c}, one row")
    tr = 1
    while tr < h and min(tr + 3, h) * w <= m_tile and \
            smem(tr + 1) <= _MAX_SMEM:
        tr += 1
    g = 1
    if tr == h:
        while g < n and (g + 1) * h * w <= m_tile and \
                smem(h, g + 1) <= _MAX_SMEM:
            g += 1
    else:
        tr = -(-h // -(-h // tr))
    return {"tile_rows": tr, "images": g, "cp": cp, "wn": wn,
            "m_tile": m_tile, "smem": smem(tr, g),
            "grid": (-(-h // tr), -(-n // g))}


def _mma_weights(w9: torch.Tensor, cp: int, nt: int) -> torch.Tensor:
    """[9, C, C] tap-major -> [cp/nt, cp/64, 9, nt, 64], zero-padded to cp:
    each (N pass, 64-channel chunk, tap) weight tile of the bf16 kernel is
    contiguous and K-major (64 input channels per output channel), in the
    order its K loop reads them."""
    c = w9.shape[1]
    if cp != c:
        w9 = F.pad(w9, (0, cp - c, 0, cp - c))
    return w9.reshape(9, cp // 64, 64, cp // nt, nt).permute(
        3, 1, 0, 4, 2).contiguous()


def basic_stack_cuda(x: torch.Tensor, blocks, *, h: int,
                     w: int) -> torch.Tensor:
    """Kernel 4, one launch per block, on CUDA tensors (weights packed in
    x's dtype by ``pack_basic_params``, biases f32): bf16 on the tensor
    cores (wgmma), f32 on the FFMA kernel."""
    _check_basic(x, blocks, h, w)
    _check_cuda(x, blocks, "basic_stack_cuda")
    lib = _basic_lib()
    n, _, c = x.shape
    stream = _cuda.stream_ptr(x.device)
    if x.dtype == torch.bfloat16:
        plan = basic_tile_plan(h, w, c, n)
        cp, wn, tr, g = plan["cp"], plan["wn"], plan["tile_rows"], \
            plan["images"]
        smem = lib.basic_block_bf16_smem_bytes(h, w, c, cp, tr, g, wn)
        if smem != plan["smem"]:
            raise RuntimeError(f"basic-block plan and kernel disagree on "
                               f"shared memory: {plan['smem']} vs {smem}")
        vec = int(c % 8 == 0 and x.data_ptr() % 16 == 0)
        for b in blocks:
            out = torch.empty_like(x)
            # Held until the launch is enqueued: a relaid-out copy freed
            # before that could hand its memory to the next allocation.
            w1t, w2t = (_mma_weights(b[k], cp, 64 * wn) for k in ("w1", "w2"))
            code = lib.basic_block_bf16_launch(
                _cuda.ptr(x), _cuda.ptr(w1t), _cuda.ptr(b["b1"]),
                _cuda.ptr(w2t), _cuda.ptr(b["b2"]), _cuda.ptr(out), n, h, w,
                c, cp, tr, g, wn, vec, stream)
            _cuda.check(code, "basic_stack")
            trace.count("launch.fused_basic_stack")
            x, vec = out, int(c % 8 == 0)
        return x
    tr = basic_tile_rows(lambda t: lib.basic_block_smem_bytes(w, c, t), h, w)
    smem = lib.basic_block_smem_bytes(w, c, tr)
    if smem > _MAX_SMEM:
        raise ValueError(f"basic-block tile needs {smem} B of shared memory "
                         f"(> {_MAX_SMEM}) at w={w}, c={c}, one row")
    for b in blocks:
        out = torch.empty_like(x)
        code = lib.basic_block_launch(
            _cuda.ptr(x), _cuda.ptr(b["w1"]), _cuda.ptr(b["b1"]),
            _cuda.ptr(b["w2"]), _cuda.ptr(b["b2"]), _cuda.ptr(out),
            n, h, w, c, tr, stream)
        _cuda.check(code, "basic_stack")
        trace.count("launch.fused_basic_stack")
        x = out
    return x


def fused_basic_stack(x: torch.Tensor, blocks, *, h: int,
                      w: int) -> torch.Tensor:
    """[N, H*W, C] -> [N, H*W, C] through the basic-block stack: kernel 4
    on a CUDA tensor, the plain version on a CPU tensor."""
    kind = x.device.type
    if kind == "cuda":
        return basic_stack_cuda(x, blocks, h=h, w=w)
    if kind == "cpu":
        return basic_stack_plain(x, blocks, h=h, w=w)
    raise ValueError(f"fused_basic_stack: unsupported device {x.device}")
