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
  goes through kernel 2's code with the pool in its x loader (same file),
  the others through kernel 2; the result equals ``maxpool_3x3_s2_nonneg``
  then ``fused_bottleneck_stack`` bit for bit.
* ``pack_basic_params`` / ``fused_basic_stack`` (kernel 4,
  ``csrc/basic_stack.cu``): a stack of stride-1 basic blocks (resnet18/34)
  with C constant, one fused block per launch.

Rounding follows the reference chains: f32 accumulation; in a bottleneck
block (``_run_chain``) y1 and y2 round to the compute dtype after
bias+ReLU and ``y3 + b3 + residual`` is summed in f32 before the last ReLU
and one rounding; in a basic block (``_run_basic_chain``) y1 rounds after
bias+ReLU and ``a2 + b2 + x`` is summed in f32 before the ReLU and one
rounding. The plain PyTorch versions below compute exactly that and are the
kernels' oracles. Each ``fused_*`` function picks by the tensor's device and
counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F

from eov_tpu_torch.ops import _cuda
from eov_tpu_torch.ops.pool import maxpool_plain

__all__ = ["pack_bottleneck_params", "fused_bottleneck_stack",
           "bottleneck_stack_plain", "bottleneck_stack_cuda",
           "stack_flops_per_img", "fused_pool_bottleneck_stack",
           "pool_bottleneck_stack_plain", "pool_bottleneck_stack_cuda",
           "pack_basic_params", "fused_basic_stack", "basic_stack_plain",
           "basic_stack_cuda", "basic_tile_rows"]

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


def bottleneck_stack_plain(x: torch.Tensor, blocks, *, h: int,
                           w: int) -> torch.Tensor:
    """Plain PyTorch version of the stack (the kernel's oracle)."""
    _check(x, blocks, h, w)
    dt = x.dtype
    for b in blocks:
        xf = x.float()
        y1 = torch.relu(xf @ b["w1"].float() + _bias(b["b1"])).to(dt)
        y2 = torch.relu(_conv3x3(y1, b["w2"], h, w) + _bias(b["b2"])).to(dt)
        y3 = y2.float() @ b["w3"].float() + _bias(b["b3"])
        res = xf @ b["wd"].float() + _bias(b["bd"]) if "wd" in b else xf
        x = torch.relu(y3 + res).to(dt)
    return x


def _lib():
    lib = _cuda.load("bottleneck_stack")
    if lib.bottleneck_block_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.bottleneck_block_launch,
                   lib.pool_bottleneck_block_launch):
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


def _launch_block(launcher, x, b, out, *, h: int, w: int,
                  bf16: int) -> None:
    """One bottleneck block through kernel 2 (or kernel 5's pool entry)."""
    cin, cmid = b["w1"].shape
    cout = b["w3"].shape[1]
    tr = tile_rows(h, w)
    smem = _lib().bottleneck_block_smem_bytes(bf16, w, cmid, tr)
    if smem > _MAX_SMEM:
        raise ValueError(f"bottleneck tile needs {smem} B of shared "
                         f"memory (> {_MAX_SMEM}) at w={w}, cmid={cmid}")
    proj = "wd" in b
    code = launcher(
        _cuda.ptr(x), _cuda.ptr(b["w1"]), _cuda.ptr(b["b1"]),
        _cuda.ptr(b["w2"]), _cuda.ptr(b["b2"]), _cuda.ptr(b["w3"]),
        _cuda.ptr(b["b3"]),
        _cuda.ptr(b["wd"]) if proj else None,
        _cuda.ptr(b["bd"]) if proj else None,
        _cuda.ptr(out), x.shape[0], h, w, cin, cmid, cout, tr, bf16,
        _cuda.stream_ptr(x.device),
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
    launcher = _lib().bottleneck_block_launch
    bf16 = int(x.dtype == torch.bfloat16)
    for b in blocks:
        out = torch.empty(x.shape[0], h * w, b["w3"].shape[1],
                          dtype=x.dtype, device=x.device)
        _launch_block(launcher, x, b, out, h=h, w=w, bf16=bf16)
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
    """Kernel 5: the first block reads the pooled map through the pool in
    its x loader (one launch), the others run on kernel 2."""
    h, w = _pooled_hw(x)
    _check_blocks(blocks, x.shape[3])
    _check_cuda(x, blocks, "pool_bottleneck_stack_cuda")
    b = blocks[0]
    out = torch.empty(x.shape[0], h * w, b["w3"].shape[1], dtype=x.dtype,
                      device=x.device)
    _launch_block(_lib().pool_bottleneck_block_launch, x, b, out, h=h, w=w,
                  bf16=int(x.dtype == torch.bfloat16))
    fused_pool_bottleneck_stack.launches += 1
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


fused_pool_bottleneck_stack.launches = 0


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


def basic_stack_plain(x: torch.Tensor, blocks, *, h: int,
                      w: int) -> torch.Tensor:
    """Plain PyTorch version of the basic stack (kernel 4's oracle)."""
    _check_basic(x, blocks, h, w)
    dt = x.dtype
    for b in blocks:
        y1 = torch.relu(_conv3x3(x, b["w1"], h, w) + _bias(b["b1"])).to(dt)
        x = torch.relu(_conv3x3(y1, b["w2"], h, w) + _bias(b["b2"])
                       + x.float()).to(dt)
    return x


def _basic_lib():
    lib = _cuda.load("basic_stack")
    fn = lib.basic_block_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i] * 6 + [p]
        fn.restype = ctypes.c_int
        lib.basic_block_smem_bytes.argtypes = [i, i, i, i]
        lib.basic_block_smem_bytes.restype = ctypes.c_longlong
    return lib


def basic_tile_rows(smem_bytes, h: int, w: int) -> int:
    """Kernel 4's output rows per thread block. ``smem_bytes(tr)`` is the
    tile's shared memory. The most rows that keep the tile within
    ``_BASIC_TILE_PX`` output pixels and two blocks per SM, then evened out
    over the tiles (the conv1 halo is recomputed per tile, so taller tiles
    waste less); one row if even that exceeds the two-per-SM budget."""
    tr = 1
    while tr < h and (tr + 1) * w <= _BASIC_TILE_PX and \
            smem_bytes(tr + 1) <= _TWO_PER_SM_SMEM:
        tr += 1
    tiles = -(-h // tr)
    return -(-h // tiles)


def basic_stack_cuda(x: torch.Tensor, blocks, *, h: int,
                     w: int) -> torch.Tensor:
    """Kernel 4, one launch per block, on CUDA tensors (weights packed in
    x's dtype by ``pack_basic_params``, biases f32)."""
    _check_basic(x, blocks, h, w)
    _check_cuda(x, blocks, "basic_stack_cuda")
    lib = _basic_lib()
    n, _, c = x.shape
    bf16 = int(x.dtype == torch.bfloat16)
    tr = basic_tile_rows(
        lambda t: lib.basic_block_smem_bytes(bf16, w, c, t), h, w)
    smem = lib.basic_block_smem_bytes(bf16, w, c, tr)
    if smem > _MAX_SMEM:
        raise ValueError(f"basic-block tile needs {smem} B of shared memory "
                         f"(> {_MAX_SMEM}) at w={w}, c={c}, one row")
    stream = _cuda.stream_ptr(x.device)
    for b in blocks:
        out = torch.empty_like(x)
        code = lib.basic_block_launch(
            _cuda.ptr(x), _cuda.ptr(b["w1"]), _cuda.ptr(b["b1"]),
            _cuda.ptr(b["w2"]), _cuda.ptr(b["b2"]), _cuda.ptr(out),
            n, h, w, c, tr, bf16, stream)
        _cuda.check(code, "basic_stack")
        fused_basic_stack.launches += 1
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


fused_basic_stack.launches = 0
