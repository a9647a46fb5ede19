"""GPU smoke test of eov_tpu_torch's main path: build, check, run, report.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card (``nvidia-smi --query-gpu=name,power.limit``);
2. build the four CUDA kernel sources from ``eov_tpu_torch/csrc/`` (one
   nvcc per source, in parallel) and time the build;
3. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes, and time kernel, plain version and, where PyTorch
   computes the function with library calls, those (CUDA events, median of
   repeats; the microsecond kernels replayed from a CUDA graph). Kernels 8
   and 9 (the train stack's forward and backward) are held at both of
   their shapes (ResNet-50 stage 1 and the stage-2 tail, 96 images) in
   bf16, and in f32 on 16 images;
4. run the extraction main path: a synthetic dataset stored at 256x320 (so
   the crop kernel runs), full-width ResNet-50 with seeded random weights,
   K=8, 32 clips per batch, bf16 -> ``extract_features`` into a store ->
   600 5-way 1-shot episodes with ``evaluate``; kernels 1-3 must each
   launch, and the results are checked against the port's plain CPU path;
5. run the train path: ``cli train`` for one short epoch (64 synthetic
   classes x 2 clips at 256x320 = 4 steps of 32 clips x 3 segments, the
   TrainConfig defaults: ResNet-50, bf16, multiscale crops, dropout 0.5,
   fused stage 1 and stage-2 tail) into a checkpoint, ``cli test`` on it,
   ``one_shot_validate`` over 5 more classes; kernels 8 and 9 must launch
   and the loss stay finite; then 5 steps on one fixed batch must lower the
   loss, and the step is timed with the frames on the card;
6. one f32 train step pair on the GPU (kernels 8 and 9, cuDNN
   deterministic) against the same two steps on the CPU (plain versions):
   loss, parameters and the stem BN statistics must agree;
7. print the ``kernels`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense
ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, *, repeats: int = 15, inner: int = 3,
            graph: bool = False) -> float:
    """Median over repeats of the mean device time of ``inner`` calls.

    ``graph=True`` captures the ``inner`` calls in a CUDA graph and times
    its replay, so a kernel of a few microseconds is not timed as the
    host's launch overhead.
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    run = lambda: [fn() for _ in range(inner)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def bound(bytes_moved: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def rel_ok(got, want, rtol, atol) -> tuple[bool, float]:
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    return ok, float(err.max())


# --------------------------------------------------------------- kernels

def check_crop(dev):
    from eov_tpu_torch.ops import crop_normalize as cn

    g = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randint(0, 256, (32 * 8, 256, 320, 3), generator=g,
                           device=dev, dtype=torch.uint8)
    got = cn.crop_normalize_cuda(frames, crop=224, dtype=torch.bfloat16)
    want = cn.crop_normalize_plain(frames, crop=224, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
        fail("crop_normalize kernel is not bitwise equal to its plain version")
    got32 = cn.crop_normalize_cuda(frames[:8], crop=224, dtype=torch.float32)
    want32 = cn.crop_normalize_plain(frames[:8], crop=224,
                                     dtype=torch.float32)
    if not torch.equal(got32.view(torch.int32), want32.view(torch.int32)):
        fail("crop_normalize kernel (f32) is not bitwise equal")
    n = frames.shape[0]
    b, by = bound(n * 224 * 224 * 3 * (1 + 2), 2 * n * 224 * 224 * 3,
                  torch.float32)
    return {
        "name": "crop_normalize", "route": "cuda",
        "source": "eov_tpu_torch/csrc/crop_normalize.cu",
        "replaces": "eov_tpu/ops/pallas_preprocess.py:52",
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "tolerance": "bitwise",
        "ms": cuda_ms(lambda: cn.crop_normalize_cuda(frames, crop=224),
                      inner=10, graph=True),
        "plain_ms": cuda_ms(lambda: cn.crop_normalize_plain(frames, crop=224),
                            inner=10, graph=True),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"u8 [{n}, 256, 320, 3] -> bf16 [{n}, 224, 224, 3]",
    }


def _stage1_blocks(dev, dtype, gen, width=64):
    """Random folded ResNet-50 stage-1 blocks, packed for the kernel."""
    cin, cmid, cout = width, width, 4 * width
    blocks = []
    for i in range(3):
        ci = cin if i == 0 else cout

        def w(*shape, fan):
            return (torch.randn(*shape, generator=gen, device=dev)
                    / fan ** 0.5).to(dtype)

        def b(c):
            return 0.1 * torch.randn(c, generator=gen, device=dev)

        blk = {"w1": w(ci, cmid, fan=ci), "b1": b(cmid),
               "w2": w(9, cmid, cmid, fan=9 * cmid), "b2": b(cmid),
               "w3": w(cmid, cout, fan=cmid), "b3": b(cout)}
        if i == 0:
            blk["wd"] = w(ci, cout, fan=ci)
            blk["bd"] = b(cout)
        blocks.append(blk)
    return blocks


def cudnn_stage(x_nhwc, blocks, h, w):
    """Stage 1 as per-conv cuDNN calls (the library yardstick), rounding as
    the unfused blocks of the forward do."""
    import torch.nn.functional as F

    n = x_nhwc.shape[0]
    dt = x_nhwc.dtype
    x = x_nhwc.reshape(n, h, w, -1).permute(0, 3, 1, 2)
    for blk in blocks:
        cmid = blk["w1"].shape[1]
        w1 = blk["w1"].t()[:, :, None, None]
        w2 = blk["w2"].reshape(3, 3, cmid, cmid).permute(3, 2, 0, 1)
        w3 = blk["w3"].t()[:, :, None, None]
        y = torch.relu(F.conv2d(x, w1) + blk["b1"].to(dt)[:, None, None])
        y = torch.relu(F.conv2d(y, w2, padding=1)
                       + blk["b2"].to(dt)[:, None, None])
        y = F.conv2d(y, w3) + blk["b3"].to(dt)[:, None, None]
        r = (F.conv2d(x, blk["wd"].t()[:, :, None, None])
             + blk["bd"].to(dt)[:, None, None]) if "wd" in blk else x
        x = torch.relu(y + r)
    return x


def check_stack(dev):
    from eov_tpu_torch.ops import bottleneck as bn

    h = w = 56
    gen = torch.Generator(device=dev).manual_seed(2)
    n = 256
    x = torch.relu(torch.randn(n, h * w, 64, generator=gen, device=dev))
    blocks = _stage1_blocks(dev, torch.bfloat16, gen)
    xb = x.to(torch.bfloat16)
    got = bn.bottleneck_stack_cuda(xb, blocks, h=h, w=w)
    want = bn.bottleneck_stack_plain(xb, blocks, h=h, w=w)
    torch.cuda.synchronize()
    ok, err = rel_ok(got, want, 2e-2, 2e-2)
    cos = torch.nn.functional.cosine_similarity(
        got.float().reshape(n, -1), want.float().reshape(n, -1), dim=1)
    if not ok or float(cos.min()) < 0.999:
        fail(f"bottleneck stack (bf16) disagrees: max err {err}, "
             f"min cosine {float(cos.min())}")
    # f32 mode (the synthetic_smoke / episode_cpu presets) on 16 images.
    b32 = [{k: v.float() for k, v in blk.items()} for blk in blocks]
    g32 = bn.bottleneck_stack_cuda(x[:16].contiguous(), b32, h=h, w=w)
    w32 = bn.bottleneck_stack_plain(x[:16].contiguous(), b32, h=h, w=w)
    ok32, err32 = rel_ok(g32, w32, 1e-4, 1e-4)
    if not ok32:
        fail(f"bottleneck stack (f32) disagrees: max err {err32}")
    flops = n * bn.stack_flops_per_img(blocks, h * w)
    io = n * h * w * (64 + 256) * 2 + sum(
        v.numel() * v.element_size() for blk in blocks for v in blk.values())
    b, by = bound(io, flops, torch.bfloat16)
    return {
        "name": "bottleneck_stack", "route": "cuda",
        "source": "eov_tpu_torch/csrc/bottleneck_stack.cu",
        "replaces": "eov_tpu/ops/pallas_bottleneck.py:371",
        "max_abs_err": err, "max_abs_err_f32": err32,
        "min_cosine": float(cos.min()),
        "tolerance": "bf16 rtol 2e-2 atol 2e-2, cosine >= 0.999; "
                     "f32 rtol 1e-4 atol 1e-4",
        "ms": cuda_ms(lambda: bn.bottleneck_stack_cuda(xb, blocks, h=h, w=w),
                      repeats=7, inner=1),
        "plain_ms": cuda_ms(
            lambda: bn.bottleneck_stack_plain(xb, blocks, h=h, w=w),
            repeats=7, inner=1),
        "bound_ms": b, "bound_by": by,
        "library_ms": cuda_ms(lambda: cudnn_stage(xb, blocks, h, w),
                              repeats=7, inner=1),
        "flops": flops,
        "shape": f"bf16 [{n}, 3136, 64] -> [{n}, 3136, 256], 3 blocks",
    }


def check_matcher(dev):
    from eov_tpu_torch.ops import similarity as sim

    gen = torch.Generator(device=dev).manual_seed(3)
    e, q, n, m, d = 64, 5, 5, 1, 2048
    query = torch.randn(e, q, d, generator=gen, device=dev)
    support = torch.randn(e, n, m, d, generator=gen, device=dev)
    mask = torch.ones(e, n, m, device=dev)
    worst = 0.0
    for metric in ("cosine", "euclidean"):
        got = sim.episode_scores_cuda(query, support, mask, metric=metric)
        want = sim.episode_scores_plain(query, support, mask, metric=metric)
        torch.cuda.synchronize()
        # euclidean scores are ~ -2D: same atol plus f32 relative rounding
        ok, err = rel_ok(got, want, 0.0 if metric == "cosine" else 1e-6,
                         1e-5)
        if not ok:
            fail(f"episode matcher ({metric}) disagrees: max err {err}")
        if metric == "cosine":
            worst = err
    # masked members (ragged support, M=3)
    sup3 = torch.randn(e, n, 3, d, generator=gen, device=dev)
    m3 = (torch.rand(e, n, 3, generator=gen, device=dev) > 0.3).float()
    m3[..., 0] = 1
    ok, err = rel_ok(sim.episode_scores_cuda(query, sup3, m3),
                     sim.episode_scores_plain(query, sup3, m3), 0.0, 1e-5)
    if not ok:
        fail(f"episode matcher (masked) disagrees: max err {err}")
    qn = sim.l2_normalize(query)
    sn = sim.l2_normalize(support)
    b, by = bound(4 * (e * q * d + e * n * m * d + e * n * m + e * q * n),
                  2 * e * q * n * m * d, torch.float32)
    return {
        "name": "episode_scores", "route": "cuda",
        "source": "eov_tpu_torch/csrc/episode_scores.cu",
        "replaces": "eov_tpu/ops/pallas_similarity.py:84",
        "max_abs_err": worst, "tolerance": "atol 1e-5",
        "ms": cuda_ms(lambda: sim.episode_scores_cuda(query, support, mask),
                      repeats=25, inner=20, graph=True),
        "plain_ms": cuda_ms(
            lambda: sim.episode_scores_plain(query, support, mask),
            repeats=25, inner=20, graph=True),
        "bound_ms": b, "bound_by": by,
        "library_ms": cuda_ms(
            lambda: torch.einsum("eqd,enmd->eqnm", qn, sn),
            repeats=25, inner=20, graph=True),
        "library_call": "torch.einsum over normalized rows (f32, no TF32)",
        "shape": f"f32 q [{e}, {q}, {d}], s [{e}, {n}, {m}, {d}]",
    }


# Kernels 8 and 9 at the train path's two shapes: ResNet-50 stage 1 and
# the stride-1 tail of stage 2 (layer2.1-3), 96 images (32 clips x 3).
TRAIN_SHAPES = {
    "stage1": dict(h=56, w=56, cin=64, cmid=64, cout=256, proj=True),
    "stage2_tail": dict(h=28, w=28, cin=512, cmid=128, cout=512, proj=False),
}
TRAIN_IMAGES = 96


def _train_blocks(dev, gen, cin, cmid, cout, proj, **_):
    """Three random frozen-BN blocks: f32 conv kernels, affines ~ (1, 0)."""
    blocks = []
    for i in range(3):
        ci = cin if i == 0 else cout

        def w(*shape, fan):
            return torch.randn(*shape, generator=gen, device=dev) / fan ** 0.5

        def aff(c):
            return (1 + 0.1 * torch.randn(c, generator=gen, device=dev),
                    0.1 * torch.randn(c, generator=gen, device=dev))

        b = {"w1": w(ci, cmid, fan=ci), "w2": w(9, cmid, cmid, fan=9 * cmid),
             "w3": w(cmid, cout, fan=cmid)}
        b["s1"], b["b1"] = aff(cmid)
        b["s2"], b["b2"] = aff(cmid)
        b["s3"], b["b3"] = aff(cout)
        if i == 0 and proj:
            b["wd"] = w(ci, cout, fan=ci)
            b["sd"], b["bd"] = aff(cout)
        blocks.append(b)
    return blocks


def cudnn_train_stage(x, blocks, h, w, dt):
    """The frozen-BN stage as per-conv cuDNN calls with the train rounding
    (conv output in dt, affine/ReLU/residual in f32): the yardstick of
    kernel 8; autograd through it is the yardstick of kernel 9."""
    import torch.nn.functional as F

    n = x.shape[0]
    x = x.reshape(n, h, w, -1).permute(0, 3, 1, 2)

    def conv(inp, wt, pad=0):
        return F.conv2d(inp.to(dt), wt.to(dt), padding=pad)

    def aff(c, s, b):
        return c.float() * s[:, None, None] + b[:, None, None]

    for b in blocks:
        cmid = b["w1"].shape[1]
        w2 = b["w2"].reshape(3, 3, cmid, cmid).permute(3, 2, 0, 1)
        y = torch.relu(aff(conv(x, b["w1"].t()[:, :, None, None]), b["s1"],
                           b["b1"]))
        y = torch.relu(aff(conv(y, w2, 1), b["s2"], b["b2"]))
        z = aff(conv(y, b["w3"].t()[:, :, None, None]), b["s3"], b["b3"])
        r = (aff(conv(x, b["wd"].t()[:, :, None, None]), b["sd"], b["bd"])
             if "wd" in b else x)
        x = torch.relu(z + r)
    return x


# Kernel 9 at full shape: a ReLU mask of the backward (out > 0, y2 > 0,
# y1 > 0) flips where a pre-activation lies within rounding of zero and the
# kernel's f32 sums (in another order than the plain version's) round it
# across. That element's gradient moves by a whole dy, not by rounding; the
# transposed 3x3s of the earlier blocks spread it over thousands of
# elements of dx, and every dW upstream sums them. Measured at these
# shapes (f32, 16 images): ~3e-3 of dx's elements off by more than 1e-4 of
# the scale (at most 2.4e-2), cosine 0.9999996. So the bar at full shape is
# on the whole tensor: relative L2 error and cosine. The elementwise bar
# (every element within 2e-2 / 1e-4 of the scale) is held at small shapes
# in tests/test_torch_port_cuda.py, where no pre-activation lies that close
# to zero.
REL_L2 = {torch.bfloat16: 2e-2, torch.float32: 5e-3}


def _rel_err(got, want) -> tuple[float, float, float]:
    """(max abs err, relative L2 error, cosine) of two tensors."""
    g, p = got.float().flatten(), want.float().flatten()
    cos = float(torch.nn.functional.cosine_similarity(g, p, dim=0))
    return (float((g - p).abs().max()),
            float((g - p).norm() / p.norm().clamp_min(1e-30)), cos)


def check_train_stack(dev):
    """Kernels 8 and 9 against their plain versions (bf16 at 96 images, f32
    at 16) at both shapes; times, bounds and the cuDNN yardsticks."""
    from eov_tpu_torch.ops import bottleneck_train as bt

    gen = torch.Generator(device=dev).manual_seed(4)
    tol = {torch.bfloat16: (2e-2, 0.999), torch.float32: (1e-4, 0.99999)}
    fwd = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "library_ms": 0.0, "flops": 0, "bytes": 0, "shapes": {}}
    bwd = {k: (dict(v) if isinstance(v, dict) else v) for k, v in fwd.items()}
    for name, shp in TRAIN_SHAPES.items():
        h, w = shp["h"], shp["w"]
        blocks = _train_blocks(dev, gen, **shp)
        x = torch.relu(torch.randn(TRAIN_IMAGES, h * w, shp["cin"],
                                   generator=gen, device=dev))
        dy = torch.randn(TRAIN_IMAGES, h * w, shp["cout"], generator=gen,
                         device=dev)
        for dt, n in ((torch.bfloat16, TRAIN_IMAGES), (torch.float32, 16)):
            xs, dys = x[:n].contiguous(), dy[:n].contiguous()
            got = bt.train_stack_forward_cuda(xs, blocks, h=h, w=w, dtype=dt)
            want = bt.train_stack_forward_plain(xs, blocks, h=h, w=w,
                                                dtype=dt)
            dx, dws = bt.train_stack_backward_cuda(xs, blocks, dys, h=h, w=w,
                                                   dtype=dt)
            dx_p, dws_p = bt.train_stack_backward_plain(xs, blocks, dys, h=h,
                                                        w=w, dtype=dt)
            torch.cuda.synchronize()
            rtol, min_cos = tol[dt]
            ok, err = rel_ok(got, want, rtol, rtol)
            cos = _rel_err(got, want)[2]
            if not ok or cos < min_cos:
                fail(f"kernel 8 ({name}, {dt}) disagrees: max err {err}, "
                     f"cosine {cos}")
            pairs = [("dx", dx, dx_p)] + [
                (f"block{i}.{k}", d[k], p[k])
                for i, (d, p) in enumerate(zip(dws, dws_p)) for k in p]
            worst_abs = worst_rel = 0.0
            worst_cos = 1.0
            for label, g, p in pairs:
                a, r, c = _rel_err(g, p)
                if r > REL_L2[dt] or c < min_cos:
                    fail(f"kernel 9 ({name}, {dt}) {label} disagrees: "
                         f"relative L2 error {r}, cosine {c}")
                worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
                worst_cos = min(worst_cos, c)
            key = "bf16" if dt == torch.bfloat16 else "f32"
            fwd["shapes"].setdefault(name, {})[f"max_abs_err_{key}"] = err
            bwd["shapes"].setdefault(name, {}).update({
                f"max_abs_err_{key}": worst_abs,
                f"rel_l2_err_{key}": worst_rel,
                f"min_cosine_{key}": worst_cos})
        dt, n = torch.bfloat16, TRAIN_IMAGES
        p = h * w
        flops = n * bt.train_stack_flops(blocks, p)
        wbytes = sum(v.numel() * 4 for b in blocks for v in b.values())
        io_f = n * p * (shp["cin"] + shp["cout"]) * 4 + wbytes
        io_b = n * p * (2 * shp["cin"] + shp["cout"]) * 4 + 2 * wbytes
        xr = x.clone().requires_grad_()
        wr = [b[k].clone().requires_grad_() for b in blocks for k in b
              if k[0] == "w"]
        it = iter(wr)
        blocks_r = [{k: (next(it) if k[0] == "w" else v)
                     for k, v in b.items()} for b in blocks]
        dy_map = dy.reshape(n, h, w, -1).permute(0, 3, 1, 2)

        def lib_bwd():
            out = cudnn_train_stage(xr, blocks_r, h, w, dt)
            return torch.autograd.grad(out, [xr, *wr], dy_map)

        for row, fl, io, run, plain, lib in (
                (fwd, flops, io_f,
                 lambda: bt.train_stack_forward_cuda(x, blocks, h=h, w=w,
                                                     dtype=dt),
                 lambda: bt.train_stack_forward_plain(x, blocks, h=h, w=w,
                                                      dtype=dt),
                 lambda: cudnn_train_stage(x, blocks, h, w, dt)),
                (bwd, 3 * flops, io_b,
                 lambda: bt.train_stack_backward_cuda(x, blocks, dy, h=h,
                                                      w=w, dtype=dt),
                 lambda: bt.train_stack_backward_plain(x, blocks, dy, h=h,
                                                       w=w, dtype=dt),
                 lib_bwd)):
            b_ms, b_by = bound(io, fl, dt)
            t = {"ms": cuda_ms(run, repeats=5, inner=1),
                 "plain_ms": cuda_ms(plain, repeats=3, inner=1),
                 "library_ms": cuda_ms(lib, repeats=5, inner=1),
                 "bound_ms": b_ms, "bound_by": b_by, "flops": fl,
                 "bytes": io}
            row["shapes"][name].update(t)
            for k in ("ms", "plain_ms", "library_ms", "flops", "bytes"):
                row[k] += t[k]
    fwd["max_abs_err"] = fwd["shapes"]["stage1"]["max_abs_err_bf16"]
    bwd["max_abs_err"] = bwd["shapes"]["stage1"]["max_abs_err_bf16"]
    common = {"route": "cuda", "source": "eov_tpu_torch/csrc/bottleneck_train.cu"}
    for row in (fwd, bwd):
        row.update(common)
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["flops"],
                                                 torch.bfloat16)
    fwd.update(name="bottleneck_train_fwd",
               replaces="eov_tpu/ops/pallas_bottleneck_train.py:435",
               tolerance="bf16 rtol 2e-2 atol 2e-2, cosine >= 0.999; f32 "
                         "rtol 1e-4 atol 1e-4, cosine >= 0.99999",
               timing="ms, plain_ms, library_ms, bound_ms: sums over the "
                      "two shapes of one train step, bf16, 96 images")
    bwd.update(name="bottleneck_train_bwd",
               replaces="eov_tpu/ops/pallas_bottleneck_train.py:612",
               tolerance="dx and every dW: relative L2 error <= 2e-2 and "
                         "cosine >= 0.999 (bf16); <= 5e-3 and >= 0.99999 "
                         "(f32) -- whole-tensor bars, as ReLU-mask flips "
                         "move single elements by a whole dy",
               library_call="torch.autograd.grad through the cuDNN stage "
                            "(its forward included, as kernel 9 recomputes)",
               timing=fwd["timing"])
    return [fwd, bwd]


# ------------------------------------------------------------- main path

def main_path(dev, gpu):
    from eov_tpu_torch.data.datasets import SyntheticVideoDataset
    from eov_tpu_torch.data.segments import center_indices_np
    from eov_tpu_torch.data.store import FeatureStore
    from eov_tpu_torch.eval import EvalConfig, evaluate
    from eov_tpu_torch.extract import (ExtractConfig, extract_features,
                                       make_feature_fn)
    from eov_tpu_torch.models.resnet import random_state_dict
    from eov_tpu_torch.ops import bottleneck, crop_normalize, similarity

    kernels = {"crop_normalize": crop_normalize.crop_normalize,
               "bottleneck_stack": bottleneck.fused_bottleneck_stack,
               "episode_scores": similarity.episode_class_scores}
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    ds = SyntheticVideoDataset(n_classes=12, clips_per_class=6, height=256,
                               width=320, seed=0)
    weights = random_state_dict("resnet50", seed=0)
    cfg = ExtractConfig(num_segments=8, batch_clips=32,
                        compute_dtype="bfloat16")
    feature_fn = make_feature_fn(weights, cfg, dev)
    store = FeatureStore(os.path.join(WORK, "store"),
                         class_names=ds.class_names, quant=None)
    ecfg = EvalConfig(n_way=5, k_shot=1, n_query=1, n_episodes=600,
                      episodes_per_step=64)

    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = extract_features(ds, weights, store, cfg, feature_fn=feature_fn,
                             device=dev)
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    table = store.to_table(dev)
    t0 = time.perf_counter()
    res = evaluate(table, ecfg)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}

    zero = [n for n, c in launches.items() if c == 0]
    if zero:
        fail(f"kernels never launched on the main path: {zero}")
    if stats["extracted"] != len(ds.records) or stats["failed"]:
        fail(f"extraction incomplete: {stats}")
    feats = table.features
    if tuple(feats.shape) != (12, 6, 2048) or not bool(
            torch.isfinite(feats).all()):
        fail(f"features bad: shape {tuple(feats.shape)}, finite "
             f"{bool(torch.isfinite(feats).all())}")
    if not 0.0 <= res.mean_acc <= 1.0 or len(res.per_episode) != 600:
        fail(f"eval result bad: {res}")

    # Reference checks on a small input, against the port's plain CPU path.
    recs = ds.records[:2]
    clips = np.stack([ds.get_frames(r, center_indices_np(r.num_frames, 8))
                      for r in recs])
    ref_cfg = ExtractConfig(num_segments=8, compute_dtype="float32")
    cpu = make_feature_fn(weights, ref_cfg, "cpu")(torch.from_numpy(clips))
    gpu32 = make_feature_fn(weights, ref_cfg, dev)(
        torch.from_numpy(clips)).cpu()
    stored = torch.from_numpy(np.stack(
        [store.load_all()[r.video_id][0] for r in recs]))
    cos = torch.nn.functional.cosine_similarity
    cos32 = float(cos(gpu32, cpu, dim=1).min())
    cos16 = float(cos(stored, cpu, dim=1).min())
    if cos32 < 0.99999 or cos16 < 0.99:
        fail(f"features disagree with the CPU f32 path: cosine f32 "
             f"{cos32}, bf16 main path {cos16}")
    res_cpu = evaluate(store.to_table("cpu"), ecfg)
    agree = float(np.mean(res_cpu.per_episode == res.per_episode))
    if agree < 0.99:
        fail(f"per-episode accuracy agrees with the CPU matcher on only "
             f"{agree:.4f} of episodes")

    # Where the extraction time goes: host decode (rendering the synthetic
    # clips) alone, and the feature program alone on one batch already on
    # the card.
    t0 = time.perf_counter()
    decoded = [ds.get_frames(r, center_indices_np(r.num_frames, 8))
               for r in ds.records]
    decode_s = time.perf_counter() - t0
    batch = torch.from_numpy(np.stack(decoded[:32])).to(dev)
    feat_ms = cuda_ms(lambda: feature_fn(batch), repeats=5, inner=1)
    device_s = feat_ms / 1e3 * len(ds.records) / 32
    return {
        "gpu": gpu,
        "clips": stats["extracted"],
        "extract_s": t_extract,
        "extract_clips_per_s": stats["extracted"] / t_extract,
        "host_decode_s": decode_s,
        "device_busy_est_s": device_s,
        "device_idle_share_est": 1.0 - device_s / t_extract,
        "feature_program_clips_per_s": 32 / (feat_ms / 1e3),
        "feature_program_ms_per_32_clips": feat_ms,
        "eval_s": t_eval,
        "episodes_per_s": 600 / t_eval,
        "accuracy": str(res),
        "launches": launches,
        "cosine_vs_cpu_f32": {"gpu_f32": cos32, "gpu_bf16_main": cos16},
        "episode_agreement_vs_cpu": agree,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }, str(res)


# ------------------------------------------------------------ train path

def _quiet_cli(argv) -> list[str]:
    """Run the port's CLI in-process; its stdout lines."""
    import contextlib
    import io

    from eov_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli.main(argv)
    if code != 0:
        fail(f"cli {argv[0]} exited {code}")
    return buf.getvalue().strip().splitlines()


def train_path(dev, gpu):
    """cli train (one short epoch at the TrainConfig defaults) -> checkpoint
    -> cli test -> one_shot_validate; then a timed fixed-batch run."""
    from eov_tpu_torch import prng
    from eov_tpu_torch import train as tr
    from eov_tpu_torch.data.datasets import SyntheticVideoDataset
    from eov_tpu_torch.ops import (bottleneck, bottleneck_train,
                                   crop_normalize, similarity)
    from eov_tpu_torch.utils.checkpoint import latest_step_dir, load_state

    run = os.path.join(WORK, "train_run")
    shutil.rmtree(run, ignore_errors=True)
    syn = ["--synthetic-classes", "64", "--synthetic-clips", "2",
           "--synthetic-height", "256", "--synthetic-width", "320",
           "--device", "cuda"]
    kernels = {"bottleneck_train_fwd": bottleneck_train.train_stack_forward,
               "bottleneck_train_bwd": bottleneck_train.train_stack_backward}
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = os.path.join(run, "metrics.jsonl")
    _quiet_cli(["train", *syn, "--batch", "32", "--num-segments", "3",
                "--epochs", "1", "--out", run, "--metrics", metrics])
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    if any(c == 0 for c in launches.values()):
        fail(f"train kernels never launched on the train path: {launches}")
    with open(metrics) as f:
        epoch = [e for e in map(json.loads, f) if e["event"] == "epoch"][-1]
    if epoch["steps"] != 4 or not np.isfinite(epoch["loss"]):
        fail(f"train epoch bad: {epoch}")
    ckpt = latest_step_dir(run)
    if ckpt is None or not os.path.exists(os.path.join(ckpt, "state.pt")):
        fail(f"no checkpoint under {run}")

    # test the checkpoint (cli test), on the epoch's 64 classes x 2 clips.
    t0 = time.perf_counter()
    test = json.loads(_quiet_cli(["test", *syn, "--batch", "32",
                                  "--params", run])[-1])
    test_s = time.perf_counter() - t0
    if test["n"] != 128 or not 0.0 <= test["top1"] <= 1.0:
        fail(f"test result bad: {test}")

    cfg = tr.TrainConfig()
    state = load_state(ckpt, tr.create_train_state(cfg, dev))
    if state.step != 4:
        fail(f"checkpoint step {state.step} != 4")
    val = SyntheticVideoDataset(n_classes=5, clips_per_class=2, height=256,
                                width=320, seed=1, name="val")
    for k in (crop_normalize.crop_normalize,
              bottleneck.fused_bottleneck_stack,
              similarity.episode_class_scores):
        k.launches = 0
    t0 = time.perf_counter()
    res = tr.one_shot_validate(state, cfg, val, n_episodes=40,
                               batch_clips=10)
    val_s = time.perf_counter() - t0
    if len(res.per_episode) != 40 or not 0.0 <= res.mean_acc <= 1.0:
        fail(f"one_shot_validate bad: {res}")
    if similarity.episode_class_scores.launches == 0:
        fail("one_shot_validate never reached the matcher kernel")

    # One fixed batch, the frames on the card: 7 steps; the first 5 must
    # lower the loss; steps 3-7 are timed (CUDA events, median).
    ds = SyntheticVideoDataset(n_classes=64, clips_per_class=2, height=256,
                               width=320, seed=0)
    rng = np.random.default_rng(0)
    recs = [ds.records[i] for i in rng.permutation(len(ds.records))[:32]]
    t0 = time.perf_counter()
    clips = [ds.get_frames(r, tr._tsn_train_indices(rng, r.num_frames, 3))
             for r in recs]
    decode_s = time.perf_counter() - t0
    frames = torch.from_numpy(np.stack(clips)).to(dev)
    labels = torch.tensor([r.label for r in recs], device=dev)
    step = tr.make_train_step(cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    key = prng.key(11)
    for i in range(7):
        key, sub = prng.split(key, 2).unbind(0)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = step(state, frames, labels, sub)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        losses.append(float(m["loss"]))
    if not all(np.isfinite(losses)) or not losses[4] < losses[0]:
        fail(f"5 steps on a fixed batch did not lower the loss: {losses}")
    step_ms = statistics.median(times[2:])
    steps = epoch["steps"]
    return {
        "gpu": gpu,
        "config": "TrainConfig defaults: resnet50, 64 classes, K=3, 32 "
                  "clips/step (96 images 224^2), bf16, multiscale, dropout "
                  "0.5, fused stage 1 + stage-2 tail",
        "epoch_s": epoch_s, "epoch_steps": steps,
        "epoch_loss": epoch["loss"], "epoch_clips": epoch["clips"],
        "launches": launches,
        "test": test, "test_s": test_s,
        "one_shot_validate": str(res), "one_shot_validate_s": val_s,
        "fixed_batch_losses": losses,
        "step_ms_median": step_ms, "step_ms_all": times,
        "clips_per_s": 32 / (step_ms / 1e3),
        "host_decode_s_per_32_clips": decode_s,
        "host_decode_share_est": decode_s / (decode_s + step_ms / 1e3),
        "epoch_device_busy_est_s": steps * step_ms / 1e3,
        "epoch_device_idle_share_est": 1.0 - steps * step_ms / 1e3 / epoch_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }


def gpu_vs_cpu_step(dev):
    """Two f32 steps (fused: kernels 8/9 on the GPU, plain on the CPU), same
    weights and keys: loss rel 1e-4, params atol 1e-4, stem BN stats atol
    1e-5 (the reference's own bars for its fused-vs-unfused step)."""
    from eov_tpu_torch import prng
    from eov_tpu_torch import train as tr
    from eov_tpu_torch.models.resnet import random_state_dict

    cfg = tr.TrainConfig(num_classes=64, num_segments=2, batch_clips=2,
                         compute_dtype="float32", scale_size=72,
                         crop_size=64, dropout=0.0, lr=0.01,
                         fused_stage1="on", fused_stage2="on")
    weights = random_state_dict("resnet50", seed=5, num_classes=64)
    frames = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (2, 2, 72, 90, 3), dtype=np.uint8))
    labels = torch.tensor([3, 40])
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {}
    try:
        for d in (dev, torch.device("cpu")):
            state = tr.create_train_state(cfg, d, weights=weights)
            step = tr.make_train_step(cfg, d)
            losses = []
            for i in range(2):
                state, m = step(state, frames, labels, prng.key(20 + i))
                losses.append(float(m["loss"]))
            out[d.type] = (losses, {k: v.detach().float().cpu() for k, v in
                                    state.model.state_dict().items()})
    finally:
        torch.backends.cudnn.deterministic = False
    (lg, sg), (lc, sc) = out["cuda"], out["cpu"]
    loss_rel = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(lg, lc))
    param_err = max(float((sg[k] - sc[k]).abs().max()) for k in sc
                    if "running" not in k)
    stats_err = max(float((sg[k] - sc[k]).abs().max())
                    for k in ("bn1.running_mean", "bn1.running_var"))
    if loss_rel > 1e-4 or param_err > 1e-4 or stats_err > 1e-5:
        fail(f"GPU f32 train steps disagree with the CPU plain path: loss "
             f"rel {loss_rel}, params {param_err}, stem BN stats "
             f"{stats_err}")
    return {"losses_gpu": lg, "losses_cpu": lc, "loss_rel_err": loss_rel,
            "param_max_abs_err": param_err, "bn1_stats_max_abs_err":
            stats_err, "tolerance": "loss rel 1e-4, params 1e-4, stem BN "
            "stats 1e-5"}


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke test "
              "needs a GPU", file=sys.stderr)
        return 1
    from eov_tpu_torch.models.folded_infer import use_full_f32
    from eov_tpu_torch.ops import _cuda

    gpu = card_line()
    print(gpu, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    use_full_f32()  # plain versions and f32 references: no TF32

    t0 = time.perf_counter()
    per_source = _cuda.build_all()
    build_s = time.perf_counter() - t0
    print(json.dumps({"build_s": build_s, "nvcc_s": per_source}),
          flush=True)

    rows = []
    for check in (check_crop, check_stack, check_matcher, check_train_stack):
        found = check(dev)
        for row in found if isinstance(found, list) else [found]:
            row["gpu"] = gpu
            print(json.dumps({"kernel": row["name"], "kernel_ms": row["ms"],
                              **row}), flush=True)
            rows.append(row)

    summary, acc_line = main_path(dev, gpu)
    print(json.dumps({"main_path": summary}), flush=True)
    print(acc_line, flush=True)
    train = train_path(dev, gpu)
    print(json.dumps({"train_path": train}), flush=True)
    print(json.dumps({"gpu_vs_cpu_f32_train_step": gpu_vs_cpu_step(dev)}),
          flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    launches = {**summary["launches"], **train["launches"]}
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
