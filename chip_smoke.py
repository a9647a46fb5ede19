"""GPU smoke test of eov_tpu_torch's main paths: build, check, run, report.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card (``nvidia-smi --query-gpu=name,power.limit``);
2. build the seven CUDA kernel sources from ``eov_tpu_torch/csrc/`` (one
   nvcc per source, in parallel) and time the build;
3. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes (kernel 1 bit for bit in bf16 and f32 at 256 frames
   of 256x320 and of 256x341, the UCF101 frame stored at short side 256;
   kernel 2 also at the stride-1 tails of ResNet-50
   stages 2-4, each block within 2 bf16 ulps of the stream), and time
   kernel, plain version and, where PyTorch
   computes the function with library calls, those (CUDA events, median of
   repeats; the microsecond kernels replayed from a CUDA graph). Kernels 8
   and 9 (the train stack's forward and backward) are held at both of
   their shapes (ResNet-50 stage 1 and the stage-2 tail, 96 images) in
   bf16, and in f32 on 16 images, and kernel 9's passes are timed one by
   one beside each pass's memory floor; kernel 7 (the int8 stage-1 stack) bit
   for bit at 256 images in bf16 and 16 in f32, its tile plan and the
   memory floor of one launch per block printed beside its bound; kernel
   3 also at the embodied eval's support (M=6, masked), bit-equal run to
   run; the temporal shift (``tsm_nl_resnet50``) bit for bit, forward and
   adjoint, at the 16 block inputs of a ``tsm_nl_r50_finetune`` step (128
   frames, bf16; 16 frames in f32) and through its autograd, its launches
   counted and a step's 32 launches timed beside the plain version,
   ``clone`` and the byte bound; then ``nonlocal_attention`` at res3 and
   res4 (16 clips) timed beside SDPA and the products with bf16 logits,
   each output's distance from float64 printed (``--only tsm_ops`` runs
   the build and these two alone);
4. run the extraction main path: a synthetic dataset stored at 256x320 (so
   the crop kernel runs), full-width ResNet-50 with seeded random weights,
   K=8, 32 clips per batch, bf16 -> ``extract_features`` into a store ->
   600 5-way 1-shot episodes with ``evaluate``; kernels 1-3 must each
   launch, and the results are checked against the port's plain CPU path;
   then the real-data path: 12 x 6 synthetic clips at UCF101's 240x320,
   packed by ``tools/pack_eovc`` at short side 256 into two RAW EOVC
   shards (256x341) -> ``cli extract --dataset eovc --preset tpu_batched``
   (the native loader where it builds, else the python reader; the one
   used is printed) -> ``cli eval``; kernel 1 must launch on those frames,
   the stored features agree with the CPU f32 path (cosine >= 0.99), and
   a ``--class-split`` extract holds only that split's classes; the wall
   rate, host read time and device idle share are printed;
5. run the int8 + embodied path through the CLI: ``extract --quant int8``
   of the same set (kernels 1 and 7), ``extract --quant int8
   --synthetic-virtual`` of a virtual set of the same classes,
   ``store-info``, ``eval --preset kinetics_embodied --virtual-store``
   (max fusion, and mean) and the plain eval of the same episodes (kernel
   3), ``classify --quant int8
   --embodied`` of other clips of those classes (kernel 7 with the store's
   recorded scales), ``episode``; the int8 features are held against the
   bf16 store and the CPU int8 path, the embodied episodes against the CPU;
6. run the train path: ``cli train`` for one short epoch (64 synthetic
   classes x 2 clips at 256x320 = 4 steps of 32 clips x 3 segments, the
   TrainConfig defaults: ResNet-50, bf16, multiscale crops, dropout 0.5,
   fused stage 1 and stage-2 tail) into a checkpoint, ``cli test`` on it,
   ``one_shot_validate`` over 5 more classes; kernels 8 and 9 must launch
   and the loss stay finite; then 5 steps on one fixed batch must lower the
   loss, and the step is timed with the frames on the card;
7. one f32 train step pair on the GPU (kernels 8 and 9, cuDNN
   deterministic) against the same two steps on the CPU (plain versions):
   loss, parameters and the stem BN statistics must agree;
8. the bench path: the port's four benches (``eov_tpu_torch/bench/``:
   features at 256x320 x 32 clips and at their 224x224 default, train,
   eval, e2e) in-process at short windows, each JSON line printed beside
   the card; every value > 0, the feature and train benches' MFU in (0,
   1.05], the feature bench at 256x320 x 32 clips within 15% of phase 4's
   feature program time, the e2e bench's extracted count equal to its
   records, and kernels 1, 2, 3, 8 and 9 launched there; then the
   256x320 feature bench once more under ``EOV_BENCH_TRACE`` (its slowdown
   and the steady-state summary printed) and ``cli extract --trace`` of 8
   clips, each summarized by ``tools/profile_summary`` (head row and top
   five ops printed);
9. the train levers: the TrainConfig defaults on one fixed batch and step
   key, three steps each with the stem levers off, ``stem_s2d='on'``,
   ``pool_vjp='on'`` and both (kernels 8 and 9 behind each stem), and the
   first step of each in f32; every lever run lowers the loss, its first
   stem gradient is near the lever-off one (the stem BN's in bf16 and
   conv1's in f32 within relative L2 2e-2; conv1's in bf16 within the
   lever-off bf16 gradient's own distance from f32), ``pool_vjp`` alone
   repeats the lever-off first loss; each run's median step time (seven
   more steps, the configurations in turns) beside the lever-off one;
10. the deployment benches (``bench/fused_eval``, ``classify``,
   ``episode`` with clips from a RAW EOVC shard, ``decode``), each line
   printed beside the card: the fused-vs-cached eval at its default bank
   (24 x 25 x 8 clips of 256x340 on the card, 64 episodes a step) with
   ``acc_max_delta <= 0.01``, kernels 1 and 2 launched there and kernels
   1-3 by classify and episode, a RAW decode rate; and a ``fold_bn=False``
   feature program on phase 4's 32 clips (kernel 1 crops) at per-clip
   cosine >= 0.999 (bf16) to the folded one, both timed;
11. the multi-GPU path (``multi_gpu_path``): (a) 2 ranks spawned on the
   one card over gloo (NCCL refuses two ranks a device; with more cards,
   up to 4 ranks over NCCL, one a card) run the sharded extraction of the
   main path's 72 clips at data = world and at frame 2, int8 with rank
   0's broadcast scales, 600 episodes of sharded eval (plain and
   embodied) and 3 sharded train steps at the ``TrainConfig`` defaults
   (then one in f32), each held against single-GPU runs on the same
   inputs: the same clips and labels, per-clip cosine >= 0.99 and the
   store's ||a - b|| / ||b|| <= 1e-3 (a wrong scale or a half-segment mean
   reads above it), int8 bit-equal, ``per_episode`` bit-equal, the f32
   loss within relative 1e-4;
   kernels 1, 2, 3, 7, 8 and 9 must launch on the ranks; a rank that fails
   or hangs fails the run; (b) ``extract``, ``eval`` and ``train
   --multichip`` under ``torchrun`` over NCCL (one rank a card), then
   ``test``, and the multichip store's accuracy equal to a store's written
   without ``--multichip``; (c) the parity harness's self-check with its
   pipeline B on the card (a ``null`` line with the reason if PIL does not
   import). ``--only multi_gpu_path`` runs the build and this phase alone;
12. the tracing of ``eov_tpu_torch/utils/trace.py``: 20 launches of known
   kernels, each followed by a host-only span that sleeps 5 ms, must read
   back as ``device_gap_s`` within 10% of the idle planted (each sleep
   less the kernel time still queued) and be put down to the sleeping
   span; a root under ``torch.profiler`` must report itself profiled; the
   always-on cost of a span, a device span, a count and a step is printed
   in microseconds, on and off the profiler, and so is the host time a
   step of epochs of empty steps with ``r50_finetune``'s spans and counts,
   beside the 50 us budget, and with ``tsm_nl_resnet50``'s timed
   non-local spans and shift launch counts added. ``--only trace_path``
   runs this phase alone, without the build;
13. print the ``kernels`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Phase 3 also holds kernel 6 (the stem max-pool) equal to its plain
version and ``F.max_pool2d``, kernel 4 (the basic-block stack) at
ResNet-34's four fused stack shapes (a half-scale branch under kernel 2's
bars, and full-scale weights within 2 bf16 ulps of the stream per block),
and kernel 5 (pool + stage-1 stack) equal to kernel 6 then kernel 2.
Between phases 5 and 6 the basic-block
and stem-pool path runs through the CLI on the main path's set:
``extract --arch resnet34 --fused-stages 1,2,3,4 --pallas-pool on`` ->
600 episodes, ``extract --pallas-pool fused`` (resnet50, equal to the main
path's store), the resnet34 cuDNN extraction to compare with, the f32
program against the CPU, the s2d stem and ResNet-50 with every stage's
stride-1 tail on kernel 2 (``fused_stages=(1, 2, 3, 4)``) through
``make_feature_fn``;
kernels 4-6 must each launch there. Each phase prints its time.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
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
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,  # dense
              torch.int8: 1979e12}
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


class Launches:
    """The named wrappers' kernel launches since it was made, read from
    their ``launch.<wrapper>`` trace counters: ``Launches(kernels)()``."""

    def __init__(self, kernels: dict):
        self.kernels = kernels
        self.start = self._now()

    def _now(self) -> dict:
        from eov_tpu_torch.utils import trace

        return {name: trace.counter(f"launch.{k.__name__}")
                for name, k in self.kernels.items()}

    def __call__(self) -> dict:
        now = self._now()
        return {name: int(now[name] - self.start[name]) for name in now}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def rel_ok(got, want, rtol, atol) -> tuple[bool, float]:
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    return ok, float(err.max())


# --------------------------------------------------------------- kernels

# The synthetic main path; the deploy benches' 256x340 bank and clips;
# UCF101 frames stored at short side 256.
CROP_SHAPES = ((256, 320), (256, 340), (256, 341))


def check_crop(dev):
    """Kernel 1 at 256 frames of each of CROP_SHAPES, bf16 and f32, bit for
    bit. The row's ms / plain_ms / bound_ms are the 256x320 ones (the
    earlier slices' shape); ``shapes`` holds them all."""
    from eov_tpu_torch.ops import crop_normalize as cn

    n, shapes = 256, {}
    g = torch.Generator(device=dev).manual_seed(1)
    for h, w in CROP_SHAPES:
        frames = torch.randint(0, 256, (n, h, w, 3), generator=g, device=dev,
                               dtype=torch.uint8)
        err = 0.0
        for dt, iv in ((torch.bfloat16, torch.int16),
                       (torch.float32, torch.int32)):
            got = cn.crop_normalize_cuda(frames, crop=224, dtype=dt)
            want = cn.crop_normalize_plain(frames, crop=224, dtype=dt)
            torch.cuda.synchronize()
            if not torch.equal(got.view(iv), want.view(iv)):
                fail(f"crop_normalize kernel ({dt}) is not bitwise equal to "
                     f"its plain version at {h}x{w}")
            err = max(err, float((got.float() - want.float()).abs().max()))
        b, by = bound(n * 224 * 224 * 3 * (1 + 2), 2 * n * 224 * 224 * 3,
                      torch.float32)
        shapes[f"{h}x{w}"] = {
            "ms": cuda_ms(lambda: cn.crop_normalize_cuda(frames, crop=224),
                          inner=10, graph=True),
            "plain_ms": cuda_ms(
                lambda: cn.crop_normalize_plain(frames, crop=224),
                inner=10, graph=True),
            "bound_ms": b, "bound_by": by, "max_abs_err": err}
        del frames
    first = shapes["256x320"]
    return {
        "name": "crop_normalize", "route": "cuda",
        "source": "eov_tpu_torch/csrc/crop_normalize.cu",
        "replaces": "eov_tpu/ops/pallas_preprocess.py:52",
        "max_abs_err": max(v["max_abs_err"] for v in shapes.values()),
        "tolerance": "bitwise (bf16 and f32)",
        "ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": None, "shapes": shapes,
        "note": "; ".join(f"{hw}: " + ", ".join(
            f"{k} {v}" for k, v in shapes[hw].items()
            if k in ("ms", "plain_ms", "bound_ms"))
            for hw in shapes if hw != "256x320"),
        "shape": " and ".join(f"u8 [{n}, {h}, {w}, 3]"
                              for h, w in CROP_SHAPES)
        + f" -> bf16 [{n}, 224, 224, 3]",
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


# ResNet-50's stride-1 stack tails of stages 2-4 on kernel 2 under
# ``--fused-stages 1,2,3,4``: (h = w, C, Cmid, blocks).
BOTTLENECK_TAILS = {"stage2_tail": (28, 512, 128, 3),
                    "stage3_tail": (14, 1024, 256, 5),
                    "stage4_tail": (7, 2048, 512, 2)}


def _tail_blocks(dev, gen, c, cmid, n_blocks):
    """Random folded bottleneck blocks C -> Cmid -> C, LeCun scale, bf16."""
    def w(*shape, fan):
        return (torch.randn(*shape, generator=gen, device=dev)
                / fan ** 0.5).to(torch.bfloat16)

    def b(k):
        return 0.1 * torch.randn(k, generator=gen, device=dev)

    return [{"w1": w(c, cmid, fan=c), "b1": b(cmid),
             "w2": w(9, cmid, cmid, fan=9 * cmid), "b2": b(cmid),
             "w3": w(cmid, c, fan=cmid), "b3": b(c)}
            for _ in range(n_blocks)]


def _bottleneck_block_ulps(bn, x, blocks, h, w) -> list:
    """Each block of kernel 2 fed the plain version's stream: its worst
    error in bf16 ulps of the magnitude the stream carries at the element's
    pixel (``bottleneck_stack_plain(stream_max=True)``)."""
    ulps = []
    for b in blocks:
        got = bn.bottleneck_stack_cuda(x, [b], h=h, w=w)
        want, top = bn.bottleneck_stack_plain(x, [b], h=h, w=w,
                                              stream_max=True)
        ulps.append(_stream_ulps(got, want, top))
        x = want
    return ulps


def _block_io_bytes(x, blocks) -> int:
    """Bytes each block of a stack reads (its input) and writes (its
    output), summed: what one launch per block moves through device
    memory."""
    n, p, c = x.shape
    total = 0
    for b in blocks:
        cout = b["w3"].shape[1]
        total += n * p * (c + cout) * x.element_size()
        c = cout
    return total


F32_STACK_IMAGES = (8, 16, 64)


def check_stack(dev):
    """Kernel 2 at ResNet-50 stage 1, 256 images: bf16 rtol/atol 2e-2 with
    per-image cosine >= 0.999, f32 on F32_STACK_IMAGES images 1e-4; at
    stage 1 and at the stride-1 tails of stages 2-4 (64 images), each
    block fed the plain
    version's stream within 2 bf16 ulps of the stream's magnitude at the
    element's pixel; the tails' stacks at per-image cosine >= 0.9999.
    Times: stage 1 (the kernels line) and each tail beside cuDNN."""
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
    ulps = _bottleneck_block_ulps(bn, xb, blocks, h, w)
    if not ok or float(cos.min()) < 0.999 or max(ulps) > 2:
        fail(f"bottleneck stack (bf16) disagrees: max err {err}, "
             f"min cosine {float(cos.min())}, per block {ulps} ulps of the "
             f"stream (bar 2)")
    # f32 mode (the synthetic_smoke / episode_cpu presets): 8 images (one
    # clip of 8 segments: the episode bench and classify at batch 1), 16,
    # and 64 (classify's batch of 8 clips).
    b32 = [{k: v.float() for k, v in blk.items()} for blk in blocks]
    err32 = 0.0
    for n32 in F32_STACK_IMAGES:
        g32 = bn.bottleneck_stack_cuda(x[:n32].contiguous(), b32, h=h, w=w)
        w32 = bn.bottleneck_stack_plain(x[:n32].contiguous(), b32, h=h, w=w)
        ok32, e32 = rel_ok(g32, w32, 1e-4, 1e-4)
        if not ok32:
            fail(f"bottleneck stack (f32, {n32} images) disagrees: max err "
                 f"{e32}")
        err32 = max(err32, e32)
    tails = {}
    for name, (hw, c, cmid, nb) in BOTTLENECK_TAILS.items():
        m = 64
        xt = torch.relu(torch.randn(m, hw * hw, c, generator=gen, device=dev)
                        ).to(torch.bfloat16)
        bt = _tail_blocks(dev, gen, c, cmid, nb)
        t_ulps = _bottleneck_block_ulps(bn, xt, bt, hw, hw)
        gt = bn.bottleneck_stack_cuda(xt, bt, h=hw, w=hw)
        wt = bn.bottleneck_stack_plain(xt, bt, h=hw, w=hw)
        torch.cuda.synchronize()
        t_cos = float(torch.nn.functional.cosine_similarity(
            gt.float().reshape(m, -1), wt.float().reshape(m, -1),
            dim=1).min())
        if max(t_ulps) > 2 or t_cos < 0.9999:
            fail(f"bottleneck stack {name} (bf16) disagrees: per block "
                 f"{t_ulps} ulps of the stream (bar 2), stack min cosine "
                 f"{t_cos} (bar 0.9999)")
        t_flops = m * bn.stack_flops_per_img(bt, hw * hw)
        t_io = m * hw * hw * c * 2 * 2 + sum(
            v.numel() * v.element_size() for blk in bt for v in blk.values())
        t_bound, t_by = bound(t_io, t_flops, torch.bfloat16)
        plan = bn.bottleneck_tile_plan(hw, hw, c, cmid, c, m)
        tails[name] = {
            "images": m, "block_max_ulps": max(t_ulps), "min_cosine": t_cos,
            "tile_rows": plan["tile_rows"], "wn1": plan["wn1"],
            "wn3": plan["wn3"], "smem": plan["smem"],
            "ms": cuda_ms(lambda: bn.bottleneck_stack_cuda(xt, bt, h=hw,
                                                           w=hw),
                          repeats=5, inner=1),
            "library_ms": cuda_ms(lambda: cudnn_stage(xt, bt, hw, hw),
                                  repeats=5, inner=1),
            "bound_ms": t_bound, "bound_by": t_by,
            "block_io_floor_ms": _block_io_bytes(xt, bt) / HBM_BYTES_PER_S
            * 1e3}
        print(f"bottleneck stack {name}: {tails[name]}", flush=True)
    flops = n * bn.stack_flops_per_img(blocks, h * w)
    io = n * h * w * (64 + 256) * 2 + sum(
        v.numel() * v.element_size() for blk in blocks for v in blk.values())
    b, by = bound(io, flops, torch.bfloat16)
    plans = {ci: bn.bottleneck_tile_plan(h, w, ci, 64, 256, n)
             for ci in (64, 256)}
    return {
        "name": "bottleneck_stack", "route": "cuda",
        "source": "eov_tpu_torch/csrc/bottleneck_stack.cu",
        "replaces": "eov_tpu/ops/pallas_bottleneck.py:371",
        "max_abs_err": err, "max_abs_err_f32": err32,
        "min_cosine": float(cos.min()), "block_max_ulps": max(ulps),
        "tolerance": "bf16 rtol 2e-2 atol 2e-2, cosine >= 0.999, each block "
                     "<= 2 ulps of the stream's magnitude at the element's "
                     "pixel; f32 (8, 16 and 64 images) rtol 1e-4 atol "
                     "1e-4; tails: per block 2 "
                     "ulps, stack cosine >= 0.9999",
        "instruction": "bf16: wgmma.mma_async m64n64k16 / m64n128k16 (A by "
                       "ldmatrix, B from a cp.async weight ring); f32: FFMA",
        "tile_plans": {f"cin{ci}": {k: p[k] for k in (
            "tile_rows", "wn1", "wn3", "smem", "steps")}
            for ci, p in plans.items()},
        "ms": cuda_ms(lambda: bn.bottleneck_stack_cuda(xb, blocks, h=h, w=w),
                      repeats=7, inner=1),
        "plain_ms": cuda_ms(
            lambda: bn.bottleneck_stack_plain(xb, blocks, h=h, w=w),
            repeats=7, inner=1),
        "bound_ms": b, "bound_by": by,
        "library_ms": cuda_ms(lambda: cudnn_stage(xb, blocks, h, w),
                              repeats=7, inner=1),
        "block_io_floor_ms": _block_io_bytes(xb, blocks) / HBM_BYTES_PER_S
        * 1e3,
        "tails": tails,
        "flops": flops,
        "shape": f"bf16 [{n}, 3136, 64] -> [{n}, 3136, 256], 3 blocks",
    }


def _int8_stage1(gen):
    """ResNet-50 stage 1 quantized as the int8 path quantizes it: seeded
    folded blocks, per-channel weight scales, per-site activation maxima
    (quant_infer.quantize_conv), on the CPU."""
    from eov_tpu_torch.models.quant_infer import quantize_conv

    amax = {"conv1": 4.0, "conv2": 3.0, "conv3": 3.0, "downsample": 4.0}
    blocks = []
    for i in range(3):
        ci = 64 if i == 0 else 256

        def conv(o, cin, k):
            return {"weight": torch.randn(o, cin, k, k, generator=gen)
                    / (cin * k * k) ** 0.5,
                    "bias": 0.1 * torch.randn(o, generator=gen)}

        fb = {"conv1": conv(64, ci, 1), "conv2": conv(64, 64, 3),
              "conv3": conv(256, 64, 1)}
        if i == 0:
            fb["downsample"] = conv(256, ci, 1)
        blocks.append({k: quantize_conv(v, amax[k]) for k, v in fb.items()})
    return blocks


def check_int8_stack(dev):
    """Kernel 7 bit for bit against its plain version (bf16 at 256 images,
    f32 at 16); the yardstick is the port's int8 walk of the same stage
    (im2col + torch._int_mm per conv), which the kernel never calls."""
    from eov_tpu_torch.models.quant_infer import qblock
    from eov_tpu_torch.ops import bottleneck_int8 as bi
    from eov_tpu_torch.ops.bottleneck import stack_flops_per_img

    h = w = 56
    n = 256
    qblocks = _int8_stage1(torch.Generator().manual_seed(7))
    packed = [{k: v.to(dev) for k, v in
               bi.pack_bottleneck_params_int8(qb).items()} for qb in qblocks]
    sites = []
    for qb in qblocks:
        st = {}
        for c, q in qb.items():
            p = bi.prepare_site(q)
            st[c] = {k: (v.to(dev) if torch.is_tensor(v) else v)
                     for k, v in p.items()}
        sites.append(st)
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.relu(torch.randn(n, h * w, 64, generator=gen, device=dev))
    xb = x.to(torch.bfloat16)
    got = bi.bottleneck_stack_int8_cuda(xb, packed, h=h, w=w)
    want = bi.bottleneck_stack_int8_plain(xb, packed, h=h, w=w)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not torch.equal(got, want):
        fail(f"int8 stack kernel (bf16) is not bitwise equal to its plain "
             f"version: max err {err}, "
             f"{float((got != want).float().mean())} of elements differ")
    x32 = x[:16].contiguous()
    g32 = bi.bottleneck_stack_int8_cuda(x32, packed, h=h, w=w)
    w32 = bi.bottleneck_stack_int8_plain(x32, packed, h=h, w=w)
    if not torch.equal(g32, w32):
        fail(f"int8 stack kernel (f32) is not bitwise equal: max err "
             f"{float((g32 - w32).abs().max())}")

    def walk():
        y = xb.reshape(n, h, w, 64)
        for st in sites:
            y = qblock(y, st, 1, torch.bfloat16)
        return y

    walk_equal = bool(torch.equal(walk().reshape(n, h * w, -1), got))
    # int8 multiply-adds x2, counted as the reference's cost estimate does
    ops = n * stack_flops_per_img(packed, h * w)
    io = n * h * w * (64 + 256) * 2 + sum(
        v.numel() * v.element_size() for b in packed for v in b.values())
    b, by = bound(io, ops, torch.int8)
    # The tiles each launch runs by, and what one launch per block must move
    # (each block's input and output through device memory).
    plans = []
    for blk in packed:
        cin, cmid = blk["w1"].shape
        p = bi.int8_tile_plan(h, w, cin, cmid, blk["w3"].shape[1], n,
                              "wd" in blk)
        plans.append({k: p[k] for k in ("tile_rows", "images", "smem",
                                        "halo", "wn1", "wn3", "steps",
                                        "grid")})
    floor_ms = _block_io_bytes(xb, packed) / HBM_BYTES_PER_S * 1e3
    print(json.dumps({"int8_stack_plan": plans,
                      "launch_floor_ms": floor_ms, "bound_ms": b}),
          flush=True)
    return {
        "name": "bottleneck_int8", "route": "cuda",
        "source": "eov_tpu_torch/csrc/bottleneck_int8.cu",
        "replaces": "eov_tpu/ops/pallas_bottleneck_int8.py:235",
        "max_abs_err": err, "max_abs_err_f32": float((g32 - w32).abs().max()),
        "tolerance": "bitwise (torch.equal), bf16 and f32",
        "nonzero_share": float((want != 0).float().mean()),
        "walk_bitwise_equal": walk_equal,
        "ms": cuda_ms(lambda: bi.bottleneck_stack_int8_cuda(xb, packed, h=h,
                                                            w=w),
                      repeats=7, inner=1),
        "plain_ms": cuda_ms(lambda: bi.bottleneck_stack_int8_plain(
            xb, packed, h=h, w=w), repeats=5, inner=1),
        "bound_ms": b, "bound_by": by,
        "library_ms": cuda_ms(walk, repeats=5, inner=1),
        "library_call": "the port's int8 walk of stage 1: per conv, requant, "
                        "im2col, torch._int_mm, dequant (not called by the "
                        "kernel)",
        "ops": ops, "bytes": io,
        "shape": f"bf16 [{n}, 3136, 64] -> [{n}, 3136, 256], 3 int8 blocks",
    }


# (queries, classes, members) of one episode, E=1.
MATCHER_DEPLOY_SHAPES = {"classify_batch8": (8, 101, 5),
                         "classify_batch1": (1, 101, 5),
                         "episode": (5, 5, 1)}


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
    # the embodied eval's support: 1 real + 5 virtual members, masked
    sup6 = torch.randn(e, n, 6, d, generator=gen, device=dev)
    m6 = (torch.rand(e, n, 6, generator=gen, device=dev) > 0.4).float()
    m6[..., 0] = 1
    err6 = {}
    for metric in ("cosine", "euclidean"):
        got6 = sim.episode_scores_cuda(query, sup6, m6, metric=metric)
        ok, err6[metric] = rel_ok(
            got6, sim.episode_scores_plain(query, sup6, m6, metric=metric),
            0.0 if metric == "cosine" else 1e-6, 1e-5)
        if not ok:
            fail(f"episode matcher (embodied M=6, masked, {metric}) "
                 f"disagrees: max err {err6[metric]}")
        if not torch.equal(got6, sim.episode_scores_cuda(query, sup6, m6,
                                                         metric=metric)):
            fail(f"episode matcher ({metric}) differs run to run")
    # The deploy benches' shapes: classify's whole split as one episode
    # (cli._class_scores: 101 classes x 5 shots against a batch of 8 or 1
    # queries) and the cold 5-way 1-shot episode.
    deploy = {}
    for name, (dq, dn, dm) in MATCHER_DEPLOY_SHAPES.items():
        qd = torch.randn(1, dq, d, generator=gen, device=dev)
        sd = torch.randn(1, dn, dm, d, generator=gen, device=dev)
        md = torch.ones(1, dn, dm, device=dev)
        ok, deploy[name] = rel_ok(sim.episode_scores_cuda(qd, sd, md),
                                  sim.episode_scores_plain(qd, sd, md),
                                  0.0, 1e-5)
        if not ok:
            fail(f"episode matcher at the {name} shape (q [1, {dq}, {d}], "
                 f"s [1, {dn}, {dm}, {d}]) disagrees: max err "
                 f"{deploy[name]}")
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
        "library_call": "torch.einsum over rows normalized beforehand (f32, "
                        "no TF32): the dots only, without the norms, the "
                        "mask and the max over members the kernel also "
                        "computes",
        "embodied_ms": cuda_ms(lambda: sim.episode_scores_cuda(query, sup6,
                                                               m6),
                               repeats=25, inner=20, graph=True),
        "embodied_max_abs_err": err6,
        "deploy_max_abs_err": deploy,
        "shape": f"f32 q [{e}, {q}, {d}], s [{e}, {n}, {m}, {d}]; embodied "
                 f"s [{e}, {n}, 6, {d}] masked; deploy (q, n, m) at E=1: "
                 + ", ".join(f"{k} {v}"
                             for k, v in MATCHER_DEPLOY_SHAPES.items()),
    }


def check_pool(dev):
    """Kernel 6 at the stem's shape (256 images bf16, 16 in f32): equal to
    its plain version and to F.max_pool2d (value equality)."""
    import torch.nn.functional as F

    from eov_tpu_torch.ops import pool

    gen = torch.Generator(device=dev).manual_seed(9)
    n = 256
    x = torch.relu(torch.randn(n, 112, 112, 64, generator=gen, device=dev)
                   ).to(torch.bfloat16)

    def lib(t):
        return F.max_pool2d(t.permute(0, 3, 1, 2), 3, 2, 1)

    for t in (x, x[:16].float().contiguous()):
        got = pool.maxpool_cuda(t)
        torch.cuda.synchronize()
        if not (torch.equal(got, pool.maxpool_plain(t))
                and torch.equal(got, lib(t).permute(0, 2, 3, 1))):
            fail(f"maxpool kernel ({t.dtype}) is not equal to its plain "
                 "version and F.max_pool2d")
    b, by = bound(n * (112 * 112 + 56 * 56) * 64 * 2, 8 * n * 56 * 56 * 64,
                  torch.bfloat16)
    return {
        "name": "maxpool_s2", "route": "cuda",
        "source": "eov_tpu_torch/csrc/maxpool_s2.cu",
        "replaces": "eov_tpu/ops/pallas_pool.py:91",
        "max_abs_err": 0.0,
        "tolerance": "torch.equal with the plain version and F.max_pool2d, "
                     "bf16 and f32",
        "ms": cuda_ms(lambda: pool.maxpool_cuda(x), inner=10, graph=True),
        "plain_ms": cuda_ms(lambda: pool.maxpool_plain(x), inner=10,
                            graph=True),
        "bound_ms": b, "bound_by": by,
        "library_ms": cuda_ms(lambda: lib(x), inner=10, graph=True),
        "library_call": "F.max_pool2d(x, 3, 2, 1), channels_last",
        "shape": f"bf16 [{n}, 112, 112, 64] -> [{n}, 56, 56, 64]",
    }


# ResNet-34's fused basic stacks at 224^2: stage 1 whole and the stride-1
# tails of stages 2-4 (h = w, C, blocks).
BASIC_STAGES = {"stage1": (56, 64, 3), "stage2_tail": (28, 128, 3),
                "stage3_tail": (14, 256, 5), "stage4_tail": (7, 512, 2)}


def _basic_blocks(dev, gen, c, n_blocks, dtype):
    """Random folded basic blocks. The branch's last conv has half the
    LeCun scale, as a trained network's folded BN keeps a block's branch
    below its skip: at full scale the residual stream of ResNet-34's
    5-block stage-3 tail grows past 8, where one bf16 rounding flip (an
    ulp of 0.0625) that the stream carries into a smaller output exceeds
    the elementwise bar whatever the kernel does (seen on the card; a CPU
    emulation with another summation order reproduces it)."""
    def w(scale=1.0):
        return (scale * torch.randn(9, c, c, generator=gen, device=dev)
                / (9 * c) ** 0.5).to(dtype)

    def b():
        return 0.1 * torch.randn(c, generator=gen, device=dev)

    return [{"w1": w(), "b1": b(), "w2": w(0.5), "b2": b()}
            for _ in range(n_blocks)]


def _full_scale_blocks(dev, gen, c, n_blocks):
    """Random folded basic blocks with both convs at the full LeCun scale
    (the stream grows past 8 at the 5-block stage-3 tail), bf16."""
    def w():
        return (torch.randn(9, c, c, generator=gen, device=dev)
                / (9 * c) ** 0.5).to(torch.bfloat16)

    return [{"w1": w(), "b1": 0.1 * torch.randn(c, generator=gen, device=dev),
             "w2": w(), "b2": 0.1 * torch.randn(c, generator=gen, device=dev)}
            for _ in range(n_blocks)]


def _stream_ulps(got, want, top) -> float:
    """Worst error in bf16 ulps of the stream's magnitude ``top``."""
    from eov_tpu_torch.ops.bottleneck import bf16_ulp

    return float(((got.float() - want.float()).abs() / bf16_ulp(top)).max())


def _basic_chain_f64(x, blocks, h, w):
    """The basic chain with float64 sums and the same bf16 roundings: the
    exact sums the kernel and the plain version each approximate."""
    import torch.nn.functional as F

    n, _, c = x.shape
    for b in blocks:
        def conv(a, w9):
            pad = F.pad(a.double().reshape(n, h, w, c), (0, 0, 1, 1, 1, 1))
            return sum(pad[:, ky:ky + h, kx:kx + w, :].reshape(n, h * w, c)
                       @ w9[ky * 3 + kx].double()
                       for ky in range(3) for kx in range(3))
        y1 = torch.relu(conv(x, b["w1"]) + b["b1"].double()).to(x.dtype)
        x = torch.relu(conv(y1, b["w2"]) + b["b2"].double()
                       + x.double()).to(x.dtype)
    return x


def check_basic_full_scale(dev, bn, name, hw, c, nb, n):
    """Kernel 4 in bf16 with full-scale weights. Each block, fed the plain
    version's stream, is held to at most 2 bf16 ulps of the magnitude the
    stream carries at the element's pixel (``basic_stack_plain(stream_max=
    True)``), and the whole stack to a per-image cosine >= 0.9999. Also
    reported: the stack's ulps against the plain version, and the plain
    version's own against float64 sums of the same chain (what two f32
    summation orders drift apart over the stack)."""
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.relu(torch.randn(n, hw * hw, c, generator=gen, device=dev)
                   ).to(torch.bfloat16)
    blocks = _full_scale_blocks(dev, gen, c, nb)
    block_ulps, xs = [], x
    for b in blocks:
        got = bn.basic_stack_cuda(xs, [b], h=hw, w=hw)
        want, top = bn.basic_stack_plain(xs, [b], h=hw, w=hw,
                                         stream_max=True)
        block_ulps.append(_stream_ulps(got, want, top))
        xs = want
    got = bn.basic_stack_cuda(x, blocks, h=hw, w=hw)
    want, top = bn.basic_stack_plain(x, blocks, h=hw, w=hw, stream_max=True)
    exact = _basic_chain_f64(x, blocks, hw, hw)
    torch.cuda.synchronize()
    cos = float(torch.nn.functional.cosine_similarity(
        got.float().reshape(n, -1), want.float().reshape(n, -1),
        dim=1).min())
    res = {"full_scale_block_max_ulps": max(block_ulps),
           "full_scale_min_cosine": cos,
           "full_scale_stack_max_ulps": _stream_ulps(got, want, top),
           "full_scale_plain_vs_f64_stack_max_ulps": _stream_ulps(
               want, exact, top),
           "full_scale_max_stream": float(top.max())}
    print(f"basic stack {name} full scale: per block max "
          f"{res['full_scale_block_max_ulps']} bf16 ulps of the stream "
          f"(largest |x| {res['full_scale_max_stream']}), stack min cosine "
          f"{cos}; stack {res['full_scale_stack_max_ulps']} ulps vs plain, "
          f"plain {res['full_scale_plain_vs_f64_stack_max_ulps']} vs f64",
          flush=True)
    if max(block_ulps) > 2 or cos < 0.9999:
        fail(f"basic stack {name} (bf16, full-scale weights) disagrees: "
             f"per block {block_ulps} ulps of the stream (bar 2), stack "
             f"min cosine {cos} (bar 0.9999)")
    return res


def cudnn_basic_stage(x, blocks, h, w):
    """A basic stack as per-conv cuDNN calls, bias, residual and ReLU in f32
    after each conv as the fused chain sums them (the library yardstick)."""
    import torch.nn.functional as F

    n, _, c = x.shape
    dt = x.dtype
    x = x.reshape(n, h, w, c).permute(0, 3, 1, 2)
    for blk in blocks:
        w1, w2 = (blk[k].reshape(3, 3, c, c).permute(3, 2, 0, 1)
                  for k in ("w1", "w2"))
        y = torch.relu(F.conv2d(x, w1, padding=1).float()
                       + blk["b1"][:, None, None]).to(dt)
        x = torch.relu(F.conv2d(y, w2, padding=1).float()
                       + blk["b2"][:, None, None] + x.float()).to(dt)
    return x


def check_basic_stack(dev):
    """Kernel 4 at each of ResNet-34's fused stack shapes: bf16 at 256
    images (rtol/atol 2e-2, per-image cosine >= 0.999) and f32 at 16 (1e-4)
    with a half-scale branch, bf16 at 256 images with full-scale weights
    (check_basic_full_scale); times per stage and summed."""
    from eov_tpu_torch.ops import bottleneck as bn

    gen = torch.Generator(device=dev).manual_seed(10)
    n = 256
    row = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0,
           "bytes": 0, "max_abs_err": 0.0, "stages": {}}
    lib = bn._basic_lib()
    for name, (hw, c, nb) in BASIC_STAGES.items():
        x = torch.relu(torch.randn(n, hw * hw, c, generator=gen, device=dev))
        st = {}
        for dt, m, tol in ((torch.bfloat16, n, 2e-2),
                           (torch.float32, 16, 1e-4)):
            blocks = _basic_blocks(dev, gen, c, nb, dt)
            xs = x[:m].to(dt).contiguous()
            got = bn.basic_stack_cuda(xs, blocks, h=hw, w=hw)
            want = bn.basic_stack_plain(xs, blocks, h=hw, w=hw)
            torch.cuda.synchronize()
            ok, err = rel_ok(got, want, tol, tol)
            cos = float(torch.nn.functional.cosine_similarity(
                got.float().reshape(m, -1), want.float().reshape(m, -1),
                dim=1).min())
            key = "bf16" if dt == torch.bfloat16 else "f32"
            if not ok or (dt == torch.bfloat16 and cos < 0.999):
                fail(f"basic stack {name} ({key}) disagrees: max err {err}, "
                     f"min cosine {cos}")
            st[f"max_abs_err_{key}"], st[f"min_cosine_{key}"] = err, cos
            st[f"max_abs_out_{key}"] = float(want.float().abs().max())
        plan = bn.basic_tile_plan(hw, hw, c, n)
        st.update(tile_rows_bf16=plan["tile_rows"],
                  images_per_block_bf16=plan["images"],
                  smem_bf16=plan["smem"],
                  tile_rows_f32=bn.basic_tile_rows(
                      lambda t: lib.basic_block_smem_bytes(hw, c, t), hw, hw))
        st.update(check_basic_full_scale(dev, bn, name, hw, c, nb, n))
        xb = x.to(torch.bfloat16)
        blocks = _basic_blocks(dev, gen, c, nb, torch.bfloat16)
        flops = n * nb * 2 * (2 * hw * hw * 9 * c * c)
        io = n * hw * hw * c * 2 * 2 + sum(
            v.numel() * v.element_size() for b in blocks for v in b.values())
        st.update(
            ms=cuda_ms(lambda: bn.basic_stack_cuda(xb, blocks, h=hw, w=hw),
                       repeats=5, inner=1),
            plain_ms=cuda_ms(lambda: bn.basic_stack_plain(xb, blocks, h=hw,
                                                          w=hw),
                             repeats=3, inner=1),
            library_ms=cuda_ms(lambda: cudnn_basic_stage(xb, blocks, hw, hw),
                               repeats=5, inner=1),
            flops=flops, bytes=io)
        st["bound_ms"], st["bound_by"] = bound(io, flops, torch.bfloat16)
        row["stages"][name] = st
        for k in ("ms", "plain_ms", "library_ms", "flops", "bytes"):
            row[k] += st[k]
        row["max_abs_err"] = max(row["max_abs_err"], st["max_abs_err_bf16"])
    row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["flops"],
                                             torch.bfloat16)
    row.update(
        name="basic_stack", route="cuda",
        source="eov_tpu_torch/csrc/basic_stack.cu",
        replaces="eov_tpu/ops/pallas_bottleneck.py:439",
        tolerance="half-scale branch: bf16 rtol 2e-2 atol 2e-2, per-image "
                  "cosine >= 0.999; f32 rtol 1e-4 atol 1e-4 (kernel 2's "
                  "bars); full-scale weights: bf16 each block <= 2 ulps "
                  "of the stream's magnitude at the element's pixel, the "
                  "stack's per-image cosine >= 0.9999",
        instruction="bf16: wgmma.mma_async m64n64k16 / m64n128k16 (A by "
                    "ldmatrix, B from a cp.async weight ring); f32: FFMA",
        library_call="per-conv cuDNN (F.conv2d, bf16), bias, residual and "
                     "ReLU in f32 as the fused chain",
        timing="ms, plain_ms, library_ms, bound_ms: sums over ResNet-34's "
               "four fused stacks (stage 1 and the tails of 2-4), bf16, "
               f"{n} images")
    return row


def _bottleneck_chain_f64(x, blocks, h, w):
    """The bottleneck chain with float64 sums and the same bf16 roundings:
    the exact sums the kernel and the plain version each approximate."""
    import torch.nn.functional as F

    n = x.shape[0]
    for b in blocks:
        xd = x.double()
        cmid = b["w1"].shape[1]
        y1 = torch.relu(xd @ b["w1"].double() + b["b1"].double()).to(x.dtype)
        pad = F.pad(y1.double().reshape(n, h, w, cmid), (0, 0, 1, 1, 1, 1))
        y2 = sum(pad[:, ky:ky + h, kx:kx + w, :].reshape(n, h * w, cmid)
                 @ b["w2"][ky * 3 + kx].double()
                 for ky in range(3) for kx in range(3))
        y2 = torch.relu(y2 + b["b2"].double()).to(x.dtype)
        res = (xd @ b["wd"].double() + b["bd"].double()) if "wd" in b else xd
        x = torch.relu(y2.double() @ b["w3"].double() + b["b3"].double()
                       + res).to(x.dtype)
    return x


def check_pool_stack(dev):
    """Kernel 5 at ResNet-50 stage 1 from the pre-pool stem map: equal to
    kernel 6 then kernel 2 (torch.equal), bf16 at 256 images and f32 at 16;
    against its plain version in f32 within 1e-4, in bf16 each block (the
    pool block through kernel 5, then kernel 2's) fed the plain version's
    stream within 2 bf16 ulps of the stream's magnitude at the element's
    pixel, the stack at per-image cosine >= 0.999. Reported beside them:
    the stack's elementwise error against the plain version, and the plain
    version's own against float64 sums of the same chain."""
    import torch.nn.functional as F

    from eov_tpu_torch.ops import bottleneck as bn
    from eov_tpu_torch.ops import pool

    gen = torch.Generator(device=dev).manual_seed(11)
    n = 256
    x = torch.relu(torch.randn(n, 112, 112, 64, generator=gen, device=dev))
    blocks = _stage1_blocks(dev, torch.bfloat16, gen)

    def k6_k2(t, bl):
        return bn.bottleneck_stack_cuda(
            pool.maxpool_cuda(t).reshape(t.shape[0], 3136, 64), bl, h=56,
            w=56)

    errs, extra = {}, {}
    for dt, m in ((torch.bfloat16, n), (torch.float32, 16)):
        bl = [{k: (v.to(dt) if k[0] == "w" else v) for k, v in b.items()}
              for b in blocks]
        xs = x[:m].to(dt).contiguous()
        got = bn.pool_bottleneck_stack_cuda(xs, bl)
        ref = k6_k2(xs, bl)
        want = bn.pool_bottleneck_stack_plain(xs, bl)
        torch.cuda.synchronize()
        ok, err = rel_ok(got, want, 2e-2 if dt == torch.bfloat16 else 1e-4,
                         2e-2 if dt == torch.bfloat16 else 1e-4)
        if not torch.equal(got, ref):
            fail(f"pool stack ({dt}) is not equal to kernel 6 then kernel 2: "
                 f"{float((got != ref).float().mean())} of elements differ")
        errs[dt] = err
        if dt == torch.float32:
            if not ok:
                fail(f"pool stack (f32) disagrees with its plain version: "
                     f"max err {err}")
            continue
        cos = float(torch.nn.functional.cosine_similarity(
            got.float().reshape(m, -1), want.float().reshape(m, -1),
            dim=1).min())
        pooled = pool.maxpool_plain(xs).reshape(m, 3136, 64)
        got0 = bn.pool_bottleneck_stack_cuda(xs, bl[:1])
        want0, top0 = bn.bottleneck_stack_plain(pooled, bl[:1], h=56, w=56,
                                                stream_max=True)
        ulps = [_stream_ulps(got0, want0, top0)] + _bottleneck_block_ulps(
            bn, want0, bl[1:], 56, 56)
        exact = _bottleneck_chain_f64(pooled[:32], bl, 56, 56)
        plain_ok, plain_err = rel_ok(want[:32], exact, 2e-2, 2e-2)
        extra = {"block_max_ulps": max(ulps), "min_cosine": cos,
                 "elementwise_2e-2_vs_plain": ok,
                 "plain_vs_f64_max_abs_err_32_images": plain_err,
                 "plain_vs_f64_elementwise_2e-2": plain_ok}
        print(f"pool stack bf16: per block {ulps} ulps of the stream, "
              f"min cosine {cos}; elementwise vs plain max err {err} "
              f"(2e-2 bar {'met' if ok else 'not met'}); plain vs f64 "
              f"max err {plain_err} (2e-2 bar "
              f"{'met' if plain_ok else 'not met'})", flush=True)
        if max(ulps) > 2 or cos < 0.999:
            fail(f"pool stack (bf16) disagrees with its plain version: per "
                 f"block {ulps} ulps of the stream (bar 2), min cosine {cos}")
    xb = x.to(torch.bfloat16)
    flops = n * (bn.stack_flops_per_img(blocks, 3136) + 3136 * 64 * 8)
    io = n * (112 * 112 * 64 + 3136 * 256) * 2 + sum(
        v.numel() * v.element_size() for b in blocks for v in b.values())
    b, by = bound(io, flops, torch.bfloat16)
    return {
        "name": "pool_bottleneck_stack", "route": "cuda",
        "source": "eov_tpu_torch/csrc/bottleneck_stack.cu",
        "replaces": "eov_tpu/ops/pallas_bottleneck.py:502",
        "max_abs_err": errs[torch.bfloat16],
        "max_abs_err_f32": errs[torch.float32],
        "equal_to_kernel6_then_kernel2": True, **extra,
        "tolerance": "torch.equal with kernel 6 then kernel 2 (bf16, f32); "
                     "vs plain: bf16 each block <= 2 ulps of the stream's "
                     "magnitude at the element's pixel, cosine >= 0.999; "
                     "f32 rtol 1e-4 atol 1e-4",
        "note": "launches counts the pool-entry block; each call also runs "
                "the stage's two other blocks on kernel 2 (counted there)",
        "ms": cuda_ms(lambda: bn.pool_bottleneck_stack_cuda(xb, blocks),
                      repeats=7, inner=1),
        "plain_ms": cuda_ms(
            lambda: bn.pool_bottleneck_stack_plain(xb, blocks), repeats=5,
            inner=1),
        "kernel6_then_kernel2_ms": cuda_ms(lambda: k6_k2(xb, blocks),
                                           repeats=7, inner=1),
        "bound_ms": b, "bound_by": by,
        "library_ms": cuda_ms(
            lambda: cudnn_stage(
                F.max_pool2d(xb.permute(0, 3, 1, 2), 3, 2, 1).permute(
                    0, 2, 3, 1), blocks, 56, 56),
            repeats=7, inner=1),
        "library_call": "F.max_pool2d then per-conv cuDNN (cudnn_stage)",
        "flops": flops, "bytes": io,
        "shape": f"bf16 [{n}, 112, 112, 64] -> [{n}, 3136, 256], 3 blocks",
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


# Kernel 9's passes in bf16, named by the launcher each calls: the
# recompute (the forward's launches before the first bwd_pre), bwd_pre,
# the input gradient and the weight gradients, which the wrapper launches
# in the order w3, w2, w1 (, wd) after each bwd_pre.
_PASS_NAMES = {"train_block_fwd_bf16_launch": "recompute",
               "train_bwd_pre_launch": "pre",
               "train_bwd_dgrad_bf16_launch": "dgrad",
               "train_wgrad_bf16_launch": "wgrad"}


def train_pass_ms(bt, run) -> dict:
    """Device ms of each pass of kernel 9 in one call of ``run``: CUDA
    events around each launcher of the train kernels' library (patched on
    the loaded library for the call), summed by pass over the blocks."""
    lib = bt._lib()
    marks, saved = [], {}
    for name in _PASS_NAMES:
        fn = getattr(lib, name)

        def call(*args, _fn=fn, _name=name):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            code = _fn(*args)
            b.record()
            marks.append((_name, a, b))
            return code

        call.argtypes = fn.argtypes
        saved[name] = fn
        setattr(lib, name, call)
    try:
        run()
    finally:
        for name, fn in saved.items():
            setattr(lib, name, fn)
    torch.cuda.synchronize()
    out, k = {}, 0
    for name, a, b in marks:
        key = _PASS_NAMES[name]
        if key == "pre":
            k = 0
        elif key == "wgrad":
            key, k = "wgrad_" + ("w3", "w2", "w1", "wd")[k], k + 1
        out[key] = out.get(key, 0.0) + a.elapsed_time(b)
    return out


def _train_pass_bytes(bt, n, h, w, blocks) -> dict:
    """Device-memory floor of each pass of kernels 8 and 9 in bf16 (each
    launch's inputs read once, its outputs written once), summed over the
    blocks: the forward (f32 x in, f32 out); the recompute (the same, and
    y1, y2 saved); bwd_pre (out and d_out in, g3, gd or d_pre out); the
    input gradient (g3, gd, y1, y2, d_pre in; g2, g1, dx out); each weight
    gradient (A, G in; the slots' partials out, then in again, and dW
    out)."""
    p, f4, b2 = n * h * w, 4, 2
    fwd = rec = pre = dgrad = 0
    wgrad = {}
    for b in blocks:
        cin, cmid = b["w1"].shape
        cout = b["w3"].shape[1]
        proj = "wd" in b
        fwd += p * (cin + cout) * f4
        rec += p * (cin + cout) * f4 + 2 * p * cmid * b2
        pre += p * cout * (2 * f4 + (2 * b2 if proj else b2 + f4))
        dgrad += (p * cout * b2 * (2 if proj else 1) + 2 * p * cmid * b2
                  + (0 if proj else p * cout * f4) + 2 * p * cmid * b2
                  + p * cin * f4)
        jobs = [("w3", cmid, cout, 1, b2), ("w2", cmid, cmid, 9, b2),
                ("w1", cin, cmid, 1, f4)] + (
            [("wd", cin, cout, 1, f4)] if proj else [])
        for name, ka, ng, taps, asz in jobs:
            part = bt.train_wgrad_plan(h, w, ka, ng, n, taps)["part"]
            wgrad[f"wgrad_{name}"] = wgrad.get(f"wgrad_{name}", 0) + (
                p * ka * asz + p * ng * b2 + 2 * part * f4
                + taps * ka * ng * f4)
    return {"forward": fwd, "recompute": rec, "pre": pre, "dgrad": dgrad,
            **wgrad}


def _train_passes(bt, x, blocks, dy, h, w) -> dict:
    """Kernel 9's passes in bf16 (median of three runs) beside each pass's
    device-memory floor."""
    n = x.shape[0]
    runs = [train_pass_ms(bt, lambda: bt.train_stack_backward_cuda(
        x, blocks, dy, h=h, w=w, dtype=torch.bfloat16)) for _ in range(3)]
    floors = _train_pass_bytes(bt, n, h, w, blocks)
    return {k: {"ms": statistics.median(r[k] for r in runs),
                "floor_ms": floors[k] / HBM_BYTES_PER_S * 1e3}
            for k in runs[0]}


def _reorder_rel_l2(bt, x, blocks, dy, h, w, dx_p, dws_p) -> float:
    """The plain backward (bf16) against itself with each block's mid
    channels permuted: the same function with its sums in another order.
    The largest relative L2 error over dx and every dW is the noise that
    any reordering of the f32 sums brings to kernel 9's whole-tensor bars
    at these inputs (a rounding flip moves a ReLU mask downstream)."""
    gen = torch.Generator(device=x.device).manual_seed(0)
    perms = [torch.randperm(b["w1"].shape[1], generator=gen, device=x.device)
             for b in blocks]
    permuted = []
    for b, pm in zip(blocks, perms):
        q = dict(b, w1=b["w1"][:, pm], w2=b["w2"][:, pm][:, :, pm],
                 w3=b["w3"][pm])
        for k in ("s1", "b1", "s2", "b2"):
            q[k] = b[k][pm]
        permuted.append(q)
    dx, dws = bt.train_stack_backward_plain(x, permuted, dy, h=h, w=w)
    worst = _rel_err(dx, dx_p)[1]
    for d, p, pm in zip(dws, dws_p, perms):
        inv = torch.argsort(pm)
        back = dict(d, w1=d["w1"][:, inv], w2=d["w2"][:, inv][:, :, inv],
                    w3=d["w3"][inv])
        worst = max([worst] + [_rel_err(back[k], p[k])[1] for k in p])
    return worst


def _flips_vs_f64(bt, x, b, h, w) -> dict:
    """Kernel 8's first block in bf16 at the check's inputs: the elements
    of y1, y2 and out whose rounding differs from the same chain with
    float64 sums, beside the plain version's count (its f32 sums)."""
    dt = torch.bfloat16

    def mm(a, wt):
        return a.double() @ wt.to(dt).double()

    def affine(c, k):
        return c.float().to(dt).float() * b["s" + k] + b["b" + k]

    xd = x.to(dt)
    y1 = torch.relu(affine(mm(xd, b["w1"]), "1")).to(dt)
    c2 = sum(mm(tap, b["w2"][t])
             for t, tap in enumerate(bt._taps(y1, h, w, +1)))
    y2 = torch.relu(affine(c2, "2")).to(dt)
    r = affine(mm(xd, b["wd"]), "d") if "wd" in b else x
    out = torch.relu(affine(mm(y2, b["w3"]), "3") + r)
    pb = bt._prep_cuda(x, [b], dt)[0]
    got = (torch.empty_like(out), torch.empty_like(y1), torch.empty_like(y2))
    bt._fwd_block_cuda(bt._lib(), x, pb, *got, h, w, True,
                       bt._cuda.stream_ptr(x.device))
    plain = bt._block_forward(x, b, h, w, dt)
    want = (out, y1, y2)
    count = lambda ts: [int((t != f).sum()) for t, f in zip(ts, want)]  # noqa: E731
    return {"out_y1_y2": count(got), "plain_out_y1_y2": count(plain),
            "n": [t.numel() for t in want]}


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
            if dt == torch.bfloat16:
                bwd["shapes"].setdefault(name, {})["reorder_rel_l2_bf16"] = (
                    _reorder_rel_l2(bt, xs, blocks, dys, h, w, dx_p, dws_p))
                fwd["shapes"].setdefault(name, {})["bf16_flips_vs_f64"] = (
                    _flips_vs_f64(bt, xs, blocks[0], h, w))
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
        # Kernel 9's passes (CUDA events around each; the median of three
        # runs) beside each pass's device-memory floor.
        passes = _train_passes(bt, x, blocks, dy, h, w)
        bwd["shapes"][name]["passes"] = passes
        floors = _train_pass_bytes(bt, n, h, w, blocks)
        fwd["shapes"][name]["block_io_floor_ms"] = (
            floors["forward"] / HBM_BYTES_PER_S * 1e3)
        bwd["shapes"][name]["block_io_floor_ms"] = sum(
            v["floor_ms"] for v in passes.values())
        print(f"kernel 9 passes {name}: {passes}", flush=True)
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
    common = {"route": "cuda",
              "source": "eov_tpu_torch/csrc/bottleneck_train.cu",
              "instruction": "bf16: wgmma.mma_async m64n64k16 / m64n128k16 "
                             "(kernel 2's three-phase block; the weight "
                             "gradients A by ldmatrix.trans, B MN-major); "
                             "f32: FFMA"}
    for row in (fwd, bwd):
        row.update(common)
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["flops"],
                                                 torch.bfloat16)
    fwd.update(name="bottleneck_train_fwd",
               replaces="eov_tpu/ops/pallas_bottleneck_train.py:435",
               tolerance="bf16 rtol 2e-2 atol 2e-2, cosine >= 0.999; f32 "
                         "rtol 1e-4 atol 1e-4, cosine >= 0.99999",
               timing="ms, plain_ms, library_ms, bound_ms: sums over the "
                      "two shapes of one train step, bf16, 96 images; "
                      "shapes.<name>.passes (kernel 9): each pass's time "
                      "and device-memory floor, summed over the blocks")
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


# ------------------------------------------------- tsm_nl_resnet50's ops

# ResNet-50's 16 bottleneck inputs at a 224² crop (side, channels): the
# shapes the temporal shift runs at in ``tsm_nl_r50_finetune``'s step.
SHIFT_INPUTS = (((56, 64),) + ((56, 256),) * 3 + ((28, 512),) * 4
                + ((14, 1024),) * 6 + ((7, 2048),) * 2)


def check_shift(dev):
    """The temporal shift kernel at a step of ``tsm_nl_r50_finetune``: the
    16 block inputs of 128 frames (T 8, fold C/8) in bf16, forward and
    adjoint, bit for bit against ``shift_plain``, and at 16 frames in f32;
    ``temporal_shift``'s autograd on the card (its gradient the adjoint);
    the launches counted by ``launch.temporal_shift``. Times: the step's
    32 launches (CUDA graph), the plain version and ``clone`` of the same
    tensors, beside the bytes they must read and write."""
    from eov_tpu_torch.ops import temporal_shift as ts
    from eov_tpu_torch.utils import trace

    gen = torch.Generator(device=dev).manual_seed(18)
    n, t = 128, 8
    xs = [torch.randn(n, c, s, s, generator=gen, device=dev).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
          for s, c in SHIFT_INPUTS]
    folds = [x.shape[1] // 8 for x in xs]

    def bits(a):
        return a.view(torch.int16 if a.dtype == torch.bfloat16
                      else torch.int32)

    l0 = trace.counter("launch.temporal_shift")
    for x, f in zip(xs, folds):
        for rev in (False, True):
            for v in (x, x[:16].float()):
                if not torch.equal(bits(ts.shift_cuda(v, t, f, rev)),
                                   bits(ts.shift_plain(v, t, f, rev))):
                    fail(f"temporal shift ({v.dtype}, {tuple(v.shape)}, "
                         f"reverse={rev}) differs from its plain version")
    x = xs[1].detach().requires_grad_(True)
    dy = torch.randn_like(x)
    y = ts.temporal_shift(x, t, folds[1])
    y.backward(dy)
    if not (torch.equal(bits(y), bits(ts.shift_plain(x, t, folds[1])))
            and torch.equal(bits(x.grad),
                            bits(ts.shift_plain(dy, t, folds[1], True)))):
        fail("temporal_shift's autograd on the card is not the shift and "
             "its adjoint")
    launches = int(trace.counter("launch.temporal_shift") - l0)
    if launches != 4 * len(xs) + 2:
        fail(f"temporal shift launched {launches} times, not "
             f"{4 * len(xs) + 2}")
    del x, dy, y

    def each(fn, rev=False):
        return lambda: [fn(v, t, f, rev) for v, f in zip(xs, folds)]

    fwd = cuda_ms(each(ts.shift_cuda), inner=1, graph=True)
    adj = cuda_ms(each(ts.shift_cuda, True), inner=1, graph=True)
    plain = (cuda_ms(each(ts.shift_plain), inner=1, graph=True)
             + cuda_ms(each(ts.shift_plain, True), inner=1, graph=True))
    copy = 2 * cuda_ms(lambda: [v.clone() for v in xs], inner=1, graph=True)
    moved = 2 * 2 * sum(v.numel() * v.element_size() for v in xs)
    b, by = bound(moved, 0, torch.bfloat16)
    return {
        "name": "temporal_shift", "route": "cuda",
        "source": "eov_tpu_torch/csrc/temporal_shift.cu",
        "replaces": "none: the JAX package has no temporal model",
        "launches": launches, "max_abs_err": 0.0,
        "tolerance": "torch.equal of the bits with shift_plain, forward and "
                     "adjoint, bf16 (128 frames) and f32 (16 frames); "
                     "autograd's gradient the adjoint",
        "ms": fwd + adj, "forward_ms": fwd, "adjoint_ms": adj,
        "plain_ms": plain, "bound_ms": b, "bound_by": by,
        "roofline": b / (fwd + adj),
        "library_ms": copy,
        "library_call": "x.clone() of each block input, twice",
        "timing": "a step's 32 launches: the 16 block inputs of "
                  "tsm_nl_r50_finetune, forward and adjoint, CUDA graph",
        "shape": f"bf16 [{n}, C, H, W], T {t}, channels_last: "
                 + ", ".join(f"{s}x{s}x{c}" for s, c in SHIFT_INPUTS),
    }


def nonlocal_times(dev) -> dict:
    """``nonlocal_attention`` at the cell's two widths (16 clips, T 8,
    bf16, logits of unit variance; res3: Ci 256 at 28², keys pooled to
    14²; res4: Ci 512 at 14², keys 7²), forward and forward + backward ms,
    beside SDPA and the products with bf16 logits, and each output's
    relative L2 distance from the float64 computation on the same inputs."""
    import torch.nn.functional as F

    from eov_tpu_torch.models.resnet import nonlocal_attention

    gen = torch.Generator(device=dev).manual_seed(19)
    n, t = 16, 8

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q[:, None], k[:, None],
                                              v[:, None], scale=1.0)[:, 0]

    def bf16_logits(q, k, v):
        a = torch.softmax(torch.bmm(q, k.transpose(1, 2)), dim=-1,
                          dtype=torch.float32)
        return torch.bmm(a.to(v.dtype), v)

    def f64(q, k, v):
        a = torch.softmax(torch.bmm(q.double(), k.double().transpose(1, 2)),
                          dim=-1)
        return torch.bmm(a, v.double())

    out = {}
    for name, side, ci in (("res3", 28, 256), ("res4", 14, 512)):
        def make(s, scale):
            return (torch.randn(n * t, ci, s, s, generator=gen, device=dev)
                    * scale).to(torch.bfloat16).contiguous(
                        memory_format=torch.channels_last)
        theta, phi = make(side, ci ** -0.25), make(side // 2, ci ** -0.25)
        g = make(side // 2, 1.0)

        def rows(x):
            return x.permute(0, 2, 3, 1).reshape(n, -1, ci)

        want = f64(rows(theta), rows(phi), rows(g))
        row = {}
        for kind, fn in (("port", None), ("sdpa", sdpa),
                         ("products_bf16_logits", bf16_logits)):
            def fwd(a=theta, b=phi, c=g, fn=fn):
                if fn is None:
                    return rows(nonlocal_attention(a, b, c, t))
                return fn(rows(a), rows(b), rows(c))
            got = fwd()
            ins = [v.detach().requires_grad_(True) for v in (theta, phi, g)]
            dy = torch.randn_like(got)

            def both(fwd=fwd, ins=ins, dy=dy):
                for v in ins:
                    v.grad = None
                fwd(*ins).backward(dy)
            row[kind] = {
                "forward_ms": cuda_ms(fwd), "fwd_bwd_ms": cuda_ms(both),
                "rel_l2_vs_f64": float((got.double() - want).norm()
                                       / want.norm())}
        out[name] = row
    return out


def tsm_ops(dev, gpu) -> dict:
    """``check_shift``'s row and ``nonlocal_times`` (``--only tsm_ops``)."""
    return {"shift": dict(check_shift(dev), gpu=gpu),
            "nonlocal_attention": nonlocal_times(dev)}


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

    since = Launches(kernels)
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
    launches = since()

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
    }, str(res), batch


# ------------------------------------------------------------ real data

def real_data_path(dev, gpu):
    """The real-data path: UCF101-sized frames (240x320, 12 classes x 6
    clips) packed by the port's pack_eovc at short side 256 into two RAW
    shards (256x341 frames) -> ``cli extract --dataset eovc --preset
    tpu_batched`` (kernels 1-3; kernel 1 on the 341-wide frames) -> ``cli
    eval``; the stored features against the CPU f32 path on the same
    packed frames, and a ``--class-split`` extract."""
    from eov_tpu_torch.data import class_splits
    from eov_tpu_torch.data.datasets import (EovcVideoDataset,
                                             SyntheticVideoDataset)
    from eov_tpu_torch.data.segments import center_indices_np
    from eov_tpu_torch.data.store import FeatureStore, MemoryFeatureStore
    from eov_tpu_torch.extract import (ExtractConfig, extract_features,
                                       make_feature_fn)
    from eov_tpu_torch.models.resnet import random_state_dict
    from eov_tpu_torch.ops import bottleneck, crop_normalize, similarity
    from eov_tpu_torch.runtime import native
    from eov_tpu_torch.tools.pack_eovc import pack

    work = os.path.join(WORK, "real")
    shards = os.path.join(work, "shards")
    src = SyntheticVideoDataset(n_classes=12, clips_per_class=6, height=240,
                                width=320, seed=0)
    t0 = time.perf_counter()
    pack(src, shards, storage_short_side=256, clips_per_shard=36)
    pack_s = time.perf_counter() - t0
    ds = EovcVideoDataset(shards)
    frame_hw = ds.get_frames(ds.records[0], [0]).shape[1:3]
    n_shards = len([f for f in os.listdir(shards) if f.endswith(".eovc")])
    if frame_hw != (256, 341) or n_shards != 2 or len(ds.records) != 72:
        fail(f"packed set: frames {frame_hw}, {n_shards} shards, "
             f"{len(ds.records)} clips; want 256x341, 2, 72")
    if ds.class_names != src.class_names:
        fail("the classes.json sidecar did not carry the class names")
    err = native.build_error()
    reader = {"reader": "native" if ds.is_native else "python",
              "native_build_error": err.splitlines()[0] if err else None}
    print(json.dumps(reader), flush=True)

    kernels = {"crop_normalize": crop_normalize.crop_normalize,
               "bottleneck_stack": bottleneck.fused_bottleneck_stack,
               "episode_scores": similarity.episode_class_scores}
    store = os.path.join(work, "store")
    since = Launches(kernels)
    t0 = time.perf_counter()
    out = _quiet_cli(["extract", "--dataset", "eovc", "--root", shards,
                      "--preset", "tpu_batched", "--store", store])
    torch.cuda.synchronize()
    cli_extract_s = time.perf_counter() - t0
    extract_launches = since()
    stats = json.loads(out[-1])
    if stats["extracted"] != 72 or stats["failed"]:
        fail(f"real-data extraction incomplete: {stats}")
    acc_line = _quiet_cli(["eval", "--store", store, "--preset",
                           "tpu_batched"])[-1]
    launches = since()
    zero = [n for n, c in launches.items() if c == 0]
    if zero or extract_launches["crop_normalize"] == 0:
        fail(f"kernels never launched on the real-data path: {zero}, "
             f"kernel 1 in extract {extract_launches['crop_normalize']}")
    if not acc_line.startswith("accuracy:"):
        fail(f"eval over the real-data store printed {acc_line!r}")

    # The stored bf16 features against the CPU f32 path on the same packed
    # frames (the main path's bar).
    weights = random_state_dict("resnet50", seed=0)  # the CLI's --seed 0
    recs = ds.records[:2]
    idx = np.stack([center_indices_np(r.num_frames, 8) for r in recs])
    clips = ds.get_batch(recs, idx)
    cpu = make_feature_fn(weights, ExtractConfig(
        num_segments=8, compute_dtype="float32"), "cpu")(
        torch.from_numpy(clips))
    saved = FeatureStore(store).load_all()
    stored = torch.from_numpy(np.stack([saved[r.video_id][0] for r in recs]))
    cos16 = float(torch.nn.functional.cosine_similarity(
        stored, cpu, dim=1).min())
    if cos16 < 0.99:
        fail(f"real-data features disagree with the CPU f32 path: cosine "
             f"{cos16}")

    # A class-split extract holds only that split's classes.
    split = class_splits.make_class_split(ds.class_names, 8, 2, 2, seed=0)
    split_path = os.path.join(work, "split.json")
    class_splits.save_class_split(split_path, split)
    test_store = os.path.join(work, "store_test")
    _quiet_cli(["extract", "--dataset", "eovc", "--root", shards,
                "--preset", "tpu_batched", "--store", test_store,
                "--class-split", f"{split_path}:test"])
    keep = split["class_splits"]["test"]
    got = FeatureStore(test_store)
    want_ids = {r.video_id for r in ds.records
                if ds.class_names[r.label] in keep}
    if got.class_names != keep or set(got.load_all()) != want_ids:
        fail(f"--class-split extract holds {got.class_names}, "
             f"{len(got.load_all())} clips; want {keep}, {len(want_ids)}")

    # Where the time goes, timed as main_path times it: extract_features
    # with the feature program built beforehand, the pooled host read
    # alone (as extract batches it), and the feature program on one
    # 32-clip batch of these frames.
    cfg = ExtractConfig(num_segments=8, batch_clips=32)
    feature_fn = make_feature_fn(weights, cfg, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = extract_features(ds, weights, MemoryFeatureStore(
        class_names=ds.class_names), cfg, feature_fn=feature_fn, device=dev)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    if timed["extracted"] != 72:
        fail(f"timed real-data extraction incomplete: {timed}")
    order = list(ds.records)
    t0 = time.perf_counter()
    for b0 in range(0, len(order), 32):
        part = order[b0:b0 + 32]
        ds.get_batch(part, np.stack([center_indices_np(r.num_frames, 8)
                                     for r in part]))
    decode_s = time.perf_counter() - t0
    batch = torch.from_numpy(ds.get_batch(order[:32], np.stack(
        [center_indices_np(r.num_frames, 8) for r in order[:32]]))).to(dev)
    feat_ms = cuda_ms(lambda: feature_fn(batch), repeats=5, inner=1)
    device_s = feat_ms / 1e3 * len(order) / 32
    return {
        "gpu": gpu, **reader,
        "frames": f"{frame_hw[0]}x{frame_hw[1]}", "shards": n_shards,
        "pack_s": pack_s,
        "clips": stats["extracted"],
        "extract_s": extract_s,
        "extract_clips_per_s": stats["extracted"] / extract_s,
        "cli_extract_s": cli_extract_s,
        "host_decode_s": decode_s,
        "device_busy_est_s": device_s,
        "device_idle_share_est": 1.0 - device_s / extract_s,
        "feature_program_ms_per_32_clips": feat_ms,
        "accuracy": acc_line,
        "launches": launches,
        "extract_launches": extract_launches,
        "cosine_vs_cpu_f32_bf16": cos16,
        "class_split_test_classes": len(keep),
    }


# ------------------------------------------------------ int8 + embodied

def int8_embodied_path(dev, gpu, batch):
    """The int8 and embodied commands through the CLI, in-process:
    extract --quant int8 (the main path's set), a virtual set of the same
    classes, store-info, embodied and plain eval, classify --quant int8
    --embodied of other clips of those classes, episode. ``batch`` is the
    main path's 32 clips on the card, for the feature-program times."""
    from eov_tpu_torch.data.store import FeatureStore
    from eov_tpu_torch.embodied import align_virtual_bank
    from eov_tpu_torch.eval import EvalConfig, evaluate
    from eov_tpu_torch.extract import (ExtractConfig, make_feature_fn,
                                       quant_calibration)
    from eov_tpu_torch.models.quant_infer import conv_sites
    from eov_tpu_torch.models.resnet import random_state_dict
    from eov_tpu_torch.ops import bottleneck_int8, crop_normalize, similarity

    work = os.path.join(WORK, "int8")
    os.makedirs(work)
    weights = random_state_dict("resnet50", seed=0)
    params = os.path.join(work, "resnet50_seed0.npz")
    np.savez(params, **{k: v.numpy() for k, v in weights.items()})
    real, virt = os.path.join(work, "real"), os.path.join(work, "virt")
    common = ["--preset", "tpu_batched", "--device", "cuda", "--params",
              params, "--synthetic-classes", "12", "--synthetic-height",
              "256", "--synthetic-width", "320"]
    kernels = {"crop_normalize": crop_normalize.crop_normalize,
               "bottleneck_int8": bottleneck_int8.fused_bottleneck_stack_int8,
               "episode_scores": similarity.episode_class_scores}
    since = Launches(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = json.loads(_quiet_cli(["extract", *common, "--store", real,
                                   "--synthetic-clips", "6", "--quant",
                                   "int8"])[-1])
    extract_s = time.perf_counter() - t0
    vstats = json.loads(_quiet_cli(["extract", *common, "--store", virt,
                                    "--synthetic-clips", "4", "--quant",
                                    "int8", "--synthetic-virtual"])[-1])
    info = [json.loads(_quiet_cli(["store-info", "--store", st])[-1])
            for st in (real, virt)]
    per_ep = {}
    t0 = time.perf_counter()
    for tag, extra in (("embodied", ["--preset", "kinetics_embodied",
                                     "--virtual-store", virt]),
                       ("embodied_mean", ["--preset", "kinetics_embodied",
                                          "--virtual-store", virt,
                                          "--fusion", "mean"]),
                       ("plain", ["--preset", "ucf101_600"])):
        per_ep[tag] = os.path.join(work, f"{tag}.json")
        _quiet_cli(["eval", "--device", "cuda", "--store", real, *extra,
                    "--per-episode-out", per_ep[tag]])
    eval_s = time.perf_counter() - t0
    preds = os.path.join(work, "classify.jsonl")
    t0 = time.perf_counter()
    _quiet_cli(["classify", *common, "--seed", "1", "--synthetic-clips",
                "2", "--store", real, "--quant", "int8", "--embodied",
                "--virtual-store", virt, "--out", preds])
    classify_s = time.perf_counter() - t0
    episode = json.loads(_quiet_cli(["episode", *common,
                                     "--synthetic-clips", "2"])[-1])
    torch.cuda.synchronize()
    launches = since()

    zero = [n for n, c in launches.items() if c == 0]
    if zero:
        fail(f"kernels never launched on the int8 + embodied path: {zero}")
    if stats["extracted"] != 72 or vstats["extracted"] != 48:
        fail(f"int8 extraction incomplete: {stats}, {vstats}")
    if [i["quant"] for i in info] != ["int8", "int8"] or not all(
            i["quant_calib"] for i in info):
        fail(f"store-info does not record int8 with scales: {info}")

    # The recorded calibration: the reference's site names, read back as
    # written, and what the same calibration gives again.
    store = FeatureStore(real)
    recorded = store.quant_calib()
    with open(os.path.join(real, "manifest.json")) as f:
        on_disk = json.load(f)["quant_calib"]
    cfg8 = ExtractConfig(num_segments=8, batch_clips=32, quant="int8")
    again = quant_calibration(weights, cfg8, device=dev)
    calib_rel = max(abs(again[k] - v) / v for k, v in recorded.items())
    if recorded != on_disk or set(recorded) != set(conv_sites("resnet50")) \
            or calib_rel > 1e-5:
        fail(f"quant_calib not recorded as computed: {len(recorded)} sites, "
             f"recomputed rel diff {calib_rel}")

    # int8 features against the bf16 main path's store and the CPU int8
    # path (same scales).
    cos = torch.nn.functional.cosine_similarity
    feats8 = store.load_all()
    feats16 = FeatureStore(os.path.join(WORK, "store")).load_all()
    ids = sorted(feats8)
    a = torch.from_numpy(np.stack([feats8[v][0] for v in ids]))
    b = torch.from_numpy(np.stack([feats16[v][0] for v in ids]))
    cos_bf16 = float(cos(a, b, dim=1).min())
    from eov_tpu_torch.data.datasets import SyntheticVideoDataset
    from eov_tpu_torch.data.segments import center_indices_np

    ds = SyntheticVideoDataset(n_classes=12, clips_per_class=6, height=256,
                               width=320, seed=0)
    recs = ds.records[:2]
    clips = torch.from_numpy(np.stack(
        [ds.get_frames(r, center_indices_np(r.num_frames, 8))
         for r in recs]))
    cpu8 = make_feature_fn(weights, cfg8, "cpu", act_max=recorded)(clips)
    gpu8 = torch.from_numpy(np.stack([feats8[r.video_id][0] for r in recs]))
    cos_cpu = float(cos(gpu8, cpu8, dim=1).min())
    if cos_bf16 < 0.99 or cos_cpu < 0.9999:
        fail(f"int8 features disagree: cosine vs bf16 {cos_bf16} (>= 0.99), "
             f"vs the CPU int8 path {cos_cpu} (>= 0.9999)")

    # Embodied eval against the CPU path, with both fusion rules; the bank
    # must change some episode. Under 'max' it need not: on this set every
    # virtual clip is further from a query than its class's real clip (the
    # virtual render has no moving square), so the prototype rule ('mean'),
    # where every virtual member enters the class score, shows it.
    per = {}
    for tag, path in per_ep.items():
        with open(path) as f:
            per[tag] = np.asarray(json.load(f)["per_episode"], np.float32)
    vstore = FeatureStore(virt)
    bank = align_virtual_bank(store.class_names, vstore.class_names,
                              vstore.to_table("cpu"))
    agree = {}
    for tag, fusion in (("embodied", "max"), ("embodied_mean", "mean")):
        res_cpu = evaluate(store.to_table("cpu"),
                           EvalConfig(embodied=True, fusion=fusion),
                           virtual=bank)
        agree[tag] = float(np.mean(res_cpu.per_episode == per[tag]))
    changed = {tag: int((per[tag] != per["plain"]).sum())
               for tag in ("embodied", "embodied_mean")}
    if len(per["embodied"]) != 600 or min(agree.values()) < 0.99 or \
            changed["embodied_mean"] == 0:
        fail(f"embodied eval bad: {len(per['embodied'])} episodes, "
             f"agreement with the CPU {agree}, episodes changed by the "
             f"virtual bank {changed}")
    with open(preds) as f:
        cls = [json.loads(line) for line in f]
    truth = [c["video_id"].split("_")[1] for c in cls]
    cls_acc = float(np.mean([c["pred_class"].endswith(t[1:])
                             for c, t in zip(cls, truth)]))
    if len(cls) != 24 or not np.isfinite([c["score"] for c in cls]).all():
        fail(f"classify output bad: {len(cls)} lines")
    if set(episode) != {"n_way", "accuracy", "preds", "truth"}:
        fail(f"episode output bad: {episode}")

    # The int8 and bf16 feature programs on the same 32 clips on the card.
    cfg16 = ExtractConfig(num_segments=8, batch_clips=32)
    fn8 = make_feature_fn(weights, cfg8, dev, act_max=recorded)
    fn16 = make_feature_fn(weights, cfg16, dev)
    ms8 = cuda_ms(lambda: fn8(batch), repeats=5, inner=1)
    ms16 = cuda_ms(lambda: fn16(batch), repeats=5, inner=1)
    # Where the int8 program's device time goes: one call under the
    # profiler, device time summed by kernel name (the top eight).
    act = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        fn8(batch)
        torch.cuda.synchronize()
    events = sorted(prof.key_averages(), key=lambda e: e.device_time_total,
                    reverse=True)
    int8_top = {e.key[:80]: {"ms": e.device_time_total / 1e3,
                             "calls": e.count} for e in events[:8]}
    int8_device_ms = sum(e.device_time_total for e in events) / 1e3
    return {
        "gpu": gpu,
        "config": "tpu_batched extract settings (K=8, 32 clips/batch, "
                  "bf16) with --quant int8 (synthetic calibration), "
                  "ResNet-50 seed-0 weights via --params; 12 classes x 6 "
                  "clips real, x 4 virtual, 256x320; 600 episodes 5-way "
                  "1-shot; classify 24 held-out clips (seed 1)",
        "launches": launches,
        "extract_s": extract_s, "extract_clips_per_s": 72 / extract_s,
        "eval_s_embodied_and_plain": eval_s, "classify_s": classify_s,
        "store_info": info,
        "calib_sites": len(recorded), "calib_recompute_rel_diff": calib_rel,
        "cosine_int8_vs_bf16_min": cos_bf16,
        "cosine_int8_gpu_vs_cpu_min": cos_cpu,
        "accuracy": {tag: float(v.mean()) for tag, v in per.items()},
        "embodied_agreement_vs_cpu": agree,
        "episodes_changed_by_virtual_bank": changed,
        "classify_accuracy": cls_acc, "episode": episode,
        "feature_program_ms_per_32_clips": {"int8": ms8, "bf16": ms16},
        "int8_program_profile": {"device_ms_total": int8_device_ms,
                                 "top_kernels": int8_top},
    }


# ------------------------------------------------- basic-block and pool

def basic_pool_path(dev, gpu, batch):
    """The basic-block and stem-pool extract path through the CLI on the
    main path's synthetic set (the same flags and seed): resnet34 with every
    stage fused and the pool kernel -> store -> 600 episodes; resnet50 with
    the pool fused into stage 1; resnet34 on cuDNN as the comparison; the
    s2d stem through make_feature_fn. ``batch`` is the main path's 32 clips
    on the card, for the feature-program times."""
    from eov_tpu_torch.data.datasets import SyntheticVideoDataset
    from eov_tpu_torch.data.segments import center_indices_np
    from eov_tpu_torch.data.store import FeatureStore
    from eov_tpu_torch.eval import EvalConfig, evaluate
    from eov_tpu_torch.extract import ExtractConfig, make_feature_fn
    from eov_tpu_torch.models.resnet import random_state_dict
    from eov_tpu_torch.ops import bottleneck, crop_normalize, pool, similarity

    work = os.path.join(WORK, "basic_pool")
    os.makedirs(work)
    stores = {t: os.path.join(work, t) for t in ("r34", "r34_cudnn", "r50")}
    per_ep = os.path.join(work, "r34_episodes.json")
    # The CLI's weights for --seed 0 without --params are
    # random_state_dict(arch, seed=0): the main path's for resnet50.
    common = ["--preset", "tpu_batched", "--device", "cuda",
              "--synthetic-classes", "12", "--synthetic-clips", "6",
              "--synthetic-height", "256", "--synthetic-width", "320"]
    r34 = ["--arch", "resnet34", "--fused-stages", "1,2,3,4",
           "--pallas-pool", "on"]
    kernels = {"crop_normalize": crop_normalize.crop_normalize,
               "basic_stack": bottleneck.fused_basic_stack,
               "maxpool_s2": pool.maxpool_3x3_s2_nonneg,
               "pool_bottleneck_stack":
                   bottleneck.fused_pool_bottleneck_stack,
               "bottleneck_stack": bottleneck.fused_bottleneck_stack,
               "episode_scores": similarity.episode_class_scores}
    since = Launches(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = json.loads(_quiet_cli(["extract", *common, *r34, "--store",
                                   stores["r34"]])[-1])
    extract_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _quiet_cli(["eval", "--device", "cuda", "--preset", "tpu_batched",
                "--store", stores["r34"], "--per-episode-out", per_ep])
    eval_s = time.perf_counter() - t0
    stats50 = json.loads(_quiet_cli(["extract", *common, "--pallas-pool",
                                     "fused", "--store", stores["r50"]])[-1])
    torch.cuda.synchronize()
    launches = since()
    zero = [n for n, c in launches.items() if c == 0]
    if zero:
        fail(f"kernels never launched on the basic-block and pool path: "
             f"{zero}")
    stats_c = json.loads(_quiet_cli(["extract", *common, "--arch",
                                     "resnet34", "--fused-stages", "none",
                                     "--pallas-pool", "off", "--store",
                                     stores["r34_cudnn"]])[-1])
    if any(s["extracted"] != 72 or s["failed"]
           for s in (stats, stats50, stats_c)):
        fail(f"extraction incomplete: {stats}, {stats50}, {stats_c}")

    cos = torch.nn.functional.cosine_similarity
    feats = {t: FeatureStore(p).load_all() for t, p in stores.items()}
    ids = sorted(feats["r34"])

    def table(tag):
        return torch.from_numpy(np.stack([feats[tag][v][0] for v in ids]))

    cos_cudnn = float(cos(table("r34"), table("r34_cudnn"), dim=1).min())
    main = FeatureStore(os.path.join(WORK, "store")).load_all()
    r50_equal = all(np.array_equal(feats["r50"][v][0], main[v][0])
                    for v in ids)
    if cos_cudnn < 0.99 or not r50_equal:
        fail(f"stores disagree: resnet34 fused+pool vs cuDNN min cosine "
             f"{cos_cudnn} (>= 0.99); resnet50 pool-fused equal to the main "
             f"path's store: {r50_equal}")

    # One f32 batch of the fused+pool program, GPU against the CPU's plain
    # path; the 600 episodes against the CPU matcher.
    ds = SyntheticVideoDataset(n_classes=12, clips_per_class=6, height=256,
                               width=320, seed=0)
    clips = torch.from_numpy(np.stack(
        [ds.get_frames(r, center_indices_np(r.num_frames, 8))
         for r in ds.records[:2]]))
    w34 = random_state_dict("resnet34", seed=0)
    cfg32 = ExtractConfig(arch="resnet34", num_segments=8,
                          compute_dtype="float32", fused_stages=(1, 2, 3, 4),
                          pallas_pool=True)
    gpu32 = make_feature_fn(w34, cfg32, dev)(clips).cpu()
    cpu32 = make_feature_fn(w34, cfg32, "cpu")(clips)
    cos32 = float(cos(gpu32, cpu32, dim=1).min())
    with open(per_ep) as f:
        per_gpu = np.asarray(json.load(f)["per_episode"], np.float32)
    res_cpu = evaluate(FeatureStore(stores["r34"]).to_table("cpu"),
                       EvalConfig(n_way=5, k_shot=1, n_query=1,
                                  n_episodes=600, episodes_per_step=64))
    agree = float(np.mean(res_cpu.per_episode == per_gpu))
    if cos32 < 0.99999 or agree < 0.99 or len(per_gpu) != 600:
        fail(f"resnet34 fused+pool vs the CPU: f32 cosine {cos32} "
             f"(>= 0.99999), episodes equal {agree} of {len(per_gpu)}")

    # The s2d stem against the 7x7 stem on the main path's batch, and the
    # feature programs' times on it (CUDA events, median of 5).
    w50 = random_state_dict("resnet50", seed=0)
    base = dict(num_segments=8, batch_clips=32)
    fns = {
        "resnet34_fused_pool": make_feature_fn(
            w34, ExtractConfig(arch="resnet34", fused_stages=(1, 2, 3, 4),
                               pallas_pool=True, **base), dev),
        "resnet34_cudnn": make_feature_fn(
            w34, ExtractConfig(arch="resnet34", **base), dev),
        "resnet50_pool_fused": make_feature_fn(
            w50, ExtractConfig(pallas_pool="fused", **base), dev),
        "resnet50_main_path": make_feature_fn(w50, ExtractConfig(**base),
                                              dev),
        "resnet50_fused_1234": make_feature_fn(
            w50, ExtractConfig(fused_stages=(1, 2, 3, 4), **base), dev),
        "resnet50_stem_s2d": make_feature_fn(
            w50, ExtractConfig(stem_s2d=True, **base), dev),
    }
    cos_s2d = float(cos(fns["resnet50_stem_s2d"](batch),
                        fns["resnet50_main_path"](batch), dim=1).min())
    cos_1234 = float(cos(fns["resnet50_fused_1234"](batch),
                         fns["resnet50_main_path"](batch), dim=1).min())
    if cos_s2d < 0.99 or cos_1234 < 0.99:
        fail(f"s2d stem vs the 7x7 stem: min per-clip cosine {cos_s2d}; "
             f"resnet50 fused stages 1-4 vs stage 1: {cos_1234}")
    ms = {k: cuda_ms(lambda fn=fn: fn(batch), repeats=5, inner=1)
          for k, fn in fns.items()}
    return {
        "gpu": gpu,
        "config": "tpu_batched extract settings (K=8, 32 clips/batch, bf16), "
                  "seed-0 weights; the main path's 12 classes x 6 clips at "
                  "256x320; 600 episodes 5-way 1-shot",
        "launches": launches,
        "extract_s_resnet34_fused_pool": extract_s,
        "extract_clips_per_s_resnet34_fused_pool": 72 / extract_s,
        "eval_s": eval_s,
        "accuracy_resnet34": float(per_gpu.mean()),
        "cosine_resnet34_fused_pool_vs_cudnn_min": cos_cudnn,
        "resnet50_pool_fused_equal_to_main_store": r50_equal,
        "cosine_resnet34_gpu_vs_cpu_f32_min": cos32,
        "episode_agreement_vs_cpu": agree,
        "cosine_stem_s2d_vs_7x7_min": cos_s2d,
        "cosine_resnet50_fused_1234_vs_main_min": cos_1234,
        "feature_program_ms_per_32_clips": ms,
    }


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
    from eov_tpu_torch.ops import bottleneck_train, similarity
    from eov_tpu_torch.utils.checkpoint import latest_step_dir, load_state

    run = os.path.join(WORK, "train_run")
    shutil.rmtree(run, ignore_errors=True)
    syn = ["--synthetic-classes", "64", "--synthetic-clips", "2",
           "--synthetic-height", "256", "--synthetic-width", "320",
           "--device", "cuda"]
    kernels = {"bottleneck_train_fwd": bottleneck_train.train_stack_forward,
               "bottleneck_train_bwd": bottleneck_train.train_stack_backward}
    since = Launches(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = os.path.join(run, "metrics.jsonl")
    _quiet_cli(["train", *syn, "--batch", "32", "--num-segments", "3",
                "--epochs", "1", "--out", run, "--metrics", metrics])
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = since()
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
    since = Launches({"episode_scores": similarity.episode_class_scores})
    t0 = time.perf_counter()
    res = tr.one_shot_validate(state, cfg, val, n_episodes=40,
                               batch_clips=10)
    val_s = time.perf_counter() - t0
    if len(res.per_episode) != 40 or not 0.0 <= res.mean_acc <= 1.0:
        fail(f"one_shot_validate bad: {res}")
    if since()["episode_scores"] == 0:
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


# ------------------------------------------------------------ bench path

def _bench_line(main, env: dict) -> dict:
    """Run a bench's ``main()`` in-process under ``env``; its one JSON
    line (anything else on stdout fails)."""
    import contextlib
    import io

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            main()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    lines = buf.getvalue().strip().splitlines()
    if len(lines) != 1:
        fail(f"a bench printed {len(lines)} lines, not one: {lines}")
    return json.loads(lines[0])


# (name, bench module, knobs): short windows; the feature bench at the
# main path's 256x320 and 32 clips (held against its feature program time),
# and at its own defaults (224x224 frames, normalize only, 64 clips).
BENCH_RUNS = (
    ("features_256x320", "features",
     {"EOV_BENCH_FRAME_HW": "256x320", "EOV_BENCH_SCALE": "256",
      "EOV_BENCH_BATCH": "32", "EOV_BENCH_WINDOW": "8",
      "EOV_BENCH_ITERS": "3", "EOV_BENCH_REPEATS": "3"}),
    ("features_224x224", "features",
     {"EOV_BENCH_WINDOW": "8", "EOV_BENCH_ITERS": "3",
      "EOV_BENCH_REPEATS": "3"}),
    ("train", "train", {"EOV_TRAIN_WINDOW": "4", "EOV_TRAIN_ITERS": "3"}),
    ("eval", "eval", {"EOV_EVAL_WINDOW": "32", "EOV_EVAL_ITERS": "3"}),
    ("e2e", "e2e", {"EOV_E2E_CLIPS": "192"}),
)


def bench_path(dev, gpu, feature_ms_32: float):
    """The four benches in-process at short windows (each JSON line printed
    beside the card), their checks, and one ``--trace`` of a small
    ``extract`` read back by ``tools/profile_summary``."""
    import importlib

    from eov_tpu_torch.ops import (bottleneck, bottleneck_train,
                                   crop_normalize, similarity)
    from eov_tpu_torch.tools.profile_summary import summarize

    kernels = {"crop_normalize": crop_normalize.crop_normalize,
               "bottleneck_stack": bottleneck.fused_bottleneck_stack,
               "episode_scores": similarity.episode_class_scores,
               "bottleneck_train_fwd": bottleneck_train.train_stack_forward,
               "bottleneck_train_bwd": bottleneck_train.train_stack_backward}
    since = Launches(kernels)
    lines = {}
    for name, module, env in BENCH_RUNS:
        main = importlib.import_module(f"eov_tpu_torch.bench.{module}").main
        t0 = time.perf_counter()
        line = _bench_line(main, {"EOV_BENCH_DEVICE": "cuda", **env})
        print(json.dumps({"bench": name, "card": gpu,
                          "s": time.perf_counter() - t0, **line}),
              flush=True)
        lines[name] = line
    launches = since()

    bad = [n for n, line in lines.items() if not line["value"] > 0]
    if bad:
        fail(f"bench values not > 0: {bad}")
    for name in ("features_256x320", "features_224x224", "train"):
        mfu = lines[name]["detail"]["mfu"]
        if mfu is None or not 0.0 < mfu <= 1.05:
            fail(f"{name} bench mfu {mfu} outside (0, 1.05]")
    bench_ms = lines["features_256x320"]["detail"]["median_step_s"] * 1e3
    rel = abs(bench_ms - feature_ms_32) / feature_ms_32
    if rel > 0.15:
        fail(f"feature bench at 256x320 x 32 clips reads {bench_ms:.3f} ms a "
             f"step, {rel:.1%} from the main path's feature program "
             f"({feature_ms_32:.3f} ms); bar 15%")
    e2e = lines["e2e"]["detail"]
    if e2e["extracted"] != e2e["clips"]:
        fail(f"e2e bench extracted {e2e['extracted']} of {e2e['clips']}")
    zero = [n for n, c in launches.items() if c == 0]
    if zero:
        fail(f"kernels never launched on the bench path: {zero}")

    # The feature bench again under EOV_BENCH_TRACE: what tracing costs,
    # and where the feature program's device time goes in steady state.
    bdir = os.path.join(WORK, "trace_bench")
    shutil.rmtree(bdir, ignore_errors=True)
    from eov_tpu_torch.bench import features

    traced = _bench_line(features.main, {"EOV_BENCH_DEVICE": "cuda",
                                         **dict(BENCH_RUNS[0][2]),
                                         "EOV_BENCH_TRACE": bdir})
    print(json.dumps({"bench": "features_256x320_traced", "card": gpu,
                      **traced}), flush=True)
    bench_rows = summarize(bdir, top=5)

    # One traced CLI run, summarized.
    tdir = os.path.join(WORK, "trace_extract")
    shutil.rmtree(tdir, ignore_errors=True)
    _quiet_cli(["extract", "--trace", tdir, "--device", "cuda",
                "--preset", "tpu_batched", "--store",
                os.path.join(WORK, "trace_store"), "--synthetic-classes", "4",
                "--synthetic-clips", "2", "--synthetic-height", "256",
                "--synthetic-width", "320", "--batch", "8"])
    rows = summarize(tdir, top=5)
    if rows[0]["device"] != "cuda" or not rows[0]["device_busy_us"] > 0:
        fail(f"trace summary of the traced extract is not a device one: "
             f"{rows[0]}")
    return {"launches": launches,
            "traced_feature_bench_slowdown": (
                lines["features_256x320"]["value"] / traced["value"] - 1.0),
            "traced_feature_bench_summary_head": bench_rows[0],
            "traced_feature_bench_top5": bench_rows[1:],
            "feature_bench_vs_main_path_rel": rel,
            "feature_bench_ms_256x320": bench_ms,
            "main_path_feature_program_ms": feature_ms_32,
            "trace_summary_head": rows[0],
            "trace_summary_top5": rows[1:]}


# ----------------------------------------------------- train levers path

def train_levers_path(dev, gpu):
    """The TrainConfig defaults (ResNet-50, 32 clips x K 3 at 224^2, bf16,
    fused stage 1 + stage-2 tail: kernels 8 and 9) on one fixed batch and
    one step key, seeded weights: three steps each with the stem levers
    off, ``stem_s2d='on'``, ``pool_vjp='on'`` and both, then the first
    step of each again in f32. Each lever run lowers the loss over its
    three steps; ``pool_vjp`` alone repeats the lever-off first loss (the
    same forward op). Each lever's first-step stem gradient against the
    lever-off one: the stem BN's (bf16) and conv1's in f32 within relative
    L2 2e-2 (kernel 9's bf16 reorder bar), and conv1's in bf16 within the
    distance of the lever-off bf16 gradient from the lever-off f32 one
    (conv1 feeds the one batch-statistics BN, so its weight gradient is a
    sum that cancels and carries bf16's rounding many times over). Step
    times by CUDA events: the median of the three, after one untimed step
    of the same configuration on a throwaway state, and of seven more
    steps each with the four configurations in turns. Spies on
    ``_S2DConv1.forward`` and the first-max pool's backward show that each
    run took its levers' paths and no other's, and under ``stem_s2d``
    conv1's gradient must differ from the lever-off one."""
    from eov_tpu_torch import prng
    from eov_tpu_torch import train as tr
    from eov_tpu_torch.models.fused_train import _S2DConv1
    from eov_tpu_torch.models.resnet import random_state_dict
    from eov_tpu_torch.ops import bottleneck_train
    from eov_tpu_torch.ops.pool import _MaxPoolVJP

    base = tr.TrainConfig()
    weights = random_state_dict(base.arch, seed=0,
                                num_classes=base.num_classes)
    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randint(0, 256, (base.batch_clips, base.num_segments,
                                    256, 320, 3), generator=gen,
                           dtype=torch.uint8, device=dev)
    labels = torch.randint(0, base.num_classes, (base.batch_clips,),
                           generator=gen, device=dev)
    key = prng.key(11)  # one key: the same crops and dropout every step
    kernels = {"bottleneck_train_fwd": bottleneck_train.train_stack_forward,
               "bottleneck_train_bwd": bottleneck_train.train_stack_backward}
    levers = (("off", {}), ("stem_s2d", {"stem_s2d": "on"}),
              ("pool_vjp", {"pool_vjp": "on"}),
              ("both", {"stem_s2d": "on", "pool_vjp": "on"}))
    stem = ("conv1.weight", "bn1.weight", "bn1.bias")

    def run(cfg, n_steps):
        step = tr.make_train_step(cfg, dev)
        # One untimed step on a throwaway state first: the first step of a
        # configuration pays cuDNN's set-up for its shapes.
        step(tr.create_train_state(cfg, dev, weights=weights), frames,
             labels, key)
        state = tr.create_train_state(cfg, dev, weights=weights)
        losses, times, grads = [], [], None
        for i in range(n_steps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            state, m = step(state, frames, labels, key)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
            losses.append(float(m["loss"]))
            if i == 0:
                params = dict(state.model.named_parameters())
                grads = {n: params[n].grad.detach().float().clone()
                         for n in stem}
        return losses, times, grads, (state, step)

    # Each run must take its levers' paths and no other's: the spies count
    # the s2d stem conv's forwards and the first-max pool's backwards.
    calls = {"stem_s2d": 0, "pool_vjp": 0}

    def spy(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    saved = (_S2DConv1.forward, _MaxPoolVJP.backward)
    _S2DConv1.forward = spy("stem_s2d", saved[0])
    _MaxPoolVJP.backward = staticmethod(spy("pool_vjp", saved[1]))
    since = Launches(kernels)
    runs, live = {}, {}
    try:
        for name, lev in levers:
            calls.update(stem_s2d=0, pool_vjp=0)
            losses, times, grads, live[name] = run(
                dataclasses.replace(base, **lev), 3)
            runs[name] = {"losses": losses, "step_ms": times,
                          "step_ms_median": statistics.median(times),
                          "grads": grads, "lever_calls": dict(calls)}
            if {f: c > 0 for f, c in calls.items()} != {
                    f: f in lev for f in calls}:
                fail(f"{name} ({lev}): the lever paths ran {calls} times")
    finally:
        _S2DConv1.forward, _MaxPoolVJP.backward = saved
    # Seven more steps of each, the configurations in turns, so that the
    # card's drift falls on all four alike.
    turns = {name: [] for name in live}
    for _ in range(7):
        for name, (state, step) in live.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            step(state, frames, labels, key)
            b.record()
            b.synchronize()
            turns[name].append(a.elapsed_time(b))
    del live
    launches = since()
    if any(c == 0 for c in launches.values()):
        fail(f"kernels 8/9 never launched on the lever path: {launches}")
    f32 = {name: run(dataclasses.replace(base, compute_dtype="float32",
                                         **lev), 1)[2]
           for name, lev in levers}

    def rel(got, want, names):
        g = torch.cat([got[n].flatten() for n in names])
        w = torch.cat([want[n].flatten() for n in names])
        return float((g - w).norm() / w.norm().clamp_min(1e-30))

    off = runs["off"]
    floor = rel(off["grads"], f32["off"], ("conv1.weight",))
    out = {"gpu": gpu, "config": "TrainConfig defaults (resnet50, 32 clips "
           "x K 3, 256x320 -> 224, bf16, fused stage 1 + stage-2 tail), one "
           "fixed batch and step key, weights random_state_dict(seed=0)",
           "launches": launches,
           "conv1_grad_rel_l2_bf16_off_vs_f32_off": floor}
    for name, run_ in runs.items():
        losses = run_["losses"]
        if not all(np.isfinite(losses)):
            fail(f"{name}: non-finite loss {losses}")
        row = {k: v for k, v in run_.items() if k != "grads"}
        row["step_ms_in_turns"] = turns[name]
        row["step_ms_in_turns_median"] = statistics.median(turns[name])
        if name != "off":
            if not losses[2] < losses[0]:
                fail(f"{name}: three steps did not lower the loss: {losses}")
            row.update(
                bn1_grad_rel_l2_bf16=rel(run_["grads"], off["grads"],
                                         ("bn1.weight", "bn1.bias")),
                conv1_grad_rel_l2_bf16=rel(run_["grads"], off["grads"],
                                           ("conv1.weight",)),
                conv1_grad_rel_l2_f32=rel(f32[name], f32["off"],
                                          ("conv1.weight",)),
                step_ms_median_off=off["step_ms_median"],
                step_ms_in_turns_ratio_vs_off=(
                    statistics.median(turns[name])
                    / statistics.median(turns["off"])))
            if "stem_s2d" in dict(levers)[name] and torch.equal(
                    run_["grads"]["conv1.weight"],
                    off["grads"]["conv1.weight"]):
                fail(f"{name}: conv1's gradient is bit-equal to the "
                     f"lever-off one: the s2d conv did not run")
            if (row["bn1_grad_rel_l2_bf16"] > 2e-2
                    or row["conv1_grad_rel_l2_f32"] > 2e-2
                    or row["conv1_grad_rel_l2_bf16"] > floor):
                fail(f"{name}: stem gradient off the lever-off one: {row} "
                     f"(bars: bn1 bf16 and conv1 f32 2e-2, conv1 bf16 "
                     f"{floor}, the bf16 path's own distance from f32)")
        out[name] = row
    lp, lo = runs["pool_vjp"]["losses"][0], off["losses"][0]
    if lp != lo:
        # The same forward op; only another cuDNN algorithm between the two
        # runs could move it, and then by rounding alone.
        r = abs(lp - lo) / abs(lo)
        print(json.dumps({"pool_vjp_first_loss_not_bit_equal": {
            "pool_vjp": lp, "off": lo, "rel": r,
            "reason": "a different cuDNN algorithm between the two runs; "
                      "bar relative 1e-6"}}), flush=True)
        if r > 1e-6:
            fail(f"pool_vjp first-step loss {lp} vs lever-off {lo}")
    out["pool_vjp_first_loss_equal_off"] = lp == lo
    return out


# ------------------------------------------------------ deploy bench path

# (name, bench module, knobs): the four deployment benches at short
# windows. fused_eval at its default bank and 64 episodes a step; classify
# and episode read their clips from a RAW EOVC shard (this machine has no
# PIL); decode at its defaults.
DEPLOY_RUNS = (
    ("fused_eval", "fused_eval",
     {"EOV_BENCH_DEVICE": "cuda", "EOV_FUSED_ITERS": "2",
      "EOV_FUSED_WINDOW": "2"}),
    ("classify", "classify",
     {"EOV_CLASSIFY_DEVICE": "cuda", "EOV_CLASSIFY_FRAMES_FROM": "eovc_raw",
      "EOV_CLASSIFY_REPEATS": "5"}),
    ("episode", "episode",
     {"EOV_EPISODE_DEVICE": "cuda", "EOV_EPISODE_FRAMES_FROM": "eovc_raw",
      "EOV_EPISODE_REPEATS": "3"}),
)


class _FusedStepCapture:
    """While active: the first fused step's first chunk of clips, as the
    fused eval bench gathers it, and the features its feature program
    returns for exactly that chunk (matched by storage, so the bench's
    cached-side calls never match), with the program's weights and
    config."""

    def __init__(self, chunk: int):
        self.chunk, self.found = chunk, {}

    def __enter__(self):
        from eov_tpu_torch import extract
        from eov_tpu_torch.bench import fused_eval

        self._saved = (fused_eval.gather_step_clips, extract.make_feature_fn)
        gather, make = self._saved
        found = self.found

        def gather_spy(*args, **kw):
            clips = gather(*args, **kw)
            if "clips" not in found:
                flat = clips.reshape(-1, *clips.shape[-4:])
                found["clips"] = flat[:self.chunk].clone()
                found["ptr"] = clips.data_ptr()
            return clips

        def make_spy(weights, cfg, dev):
            fn = make(weights, cfg, dev)
            found["make"] = (weights, cfg)

            def feature_fn(x):
                y = fn(x)
                if ("feats" not in found and found.get("ptr")
                        == x.data_ptr()):
                    found["feats"] = y.clone()
                return y
            return feature_fn

        fused_eval.gather_step_clips = gather_spy
        extract.make_feature_fn = make_spy
        return self

    def __exit__(self, *exc):
        from eov_tpu_torch import extract
        from eov_tpu_torch.bench import fused_eval

        fused_eval.gather_step_clips, extract.make_feature_fn = self._saved


def deploy_bench_path(dev, gpu, batch):
    """The fused-vs-cached eval, classify, episode and decode benches; the
    fused eval's first chunk of 64 gathered clips through the plain
    program (f32, no kernel: the resize path's crop, cuDNN stage 1) held
    against the bench's own features at the main path's per-clip bars
    (its bf16 program at cosine >= 0.99, the same kernels in f32 at
    0.99999); and a ``fold_bn=False`` extraction of the main path's batch
    held against the folded program on the same frames."""
    import contextlib
    import importlib
    import io

    from eov_tpu_torch.extract import ExtractConfig, make_feature_fn
    from eov_tpu_torch.models.resnet import random_state_dict
    from eov_tpu_torch.ops import bottleneck, crop_normalize, similarity

    kernels = {"crop_normalize": crop_normalize.crop_normalize,
               "bottleneck_stack": bottleneck.fused_bottleneck_stack,
               "episode_scores": similarity.episode_class_scores}
    lines, launches = {}, {}
    capture = _FusedStepCapture(chunk=64)
    for name, module, env in DEPLOY_RUNS:
        since = Launches(kernels)
        main = importlib.import_module(f"eov_tpu_torch.bench.{module}").main
        t0 = time.perf_counter()
        with capture if name == "fused_eval" else contextlib.nullcontext():
            line = _bench_line(main, env)
        launches[name] = since()
        print(json.dumps({"bench": name, "card": gpu,
                          "s": time.perf_counter() - t0, **line}),
              flush=True)
        lines[name] = line
    need = {"fused_eval": ("crop_normalize", "bottleneck_stack"),
            "classify": tuple(kernels), "episode": tuple(kernels)}
    for name, names in need.items():
        zero = [n for n in names if launches[name][n] == 0]
        if zero:
            fail(f"kernels never launched by the {name} bench: {zero}")
    bad = [n for n, line in lines.items() if not line["value"] > 0]
    if bad:
        fail(f"bench values not > 0: {bad}")
    fe = lines["fused_eval"]["detail"]
    if fe["bank_cmk_hw"] != [24, 25, 8, 256, 340] or fe[
            "episodes_per_step"] != 64:
        fail(f"fused eval bench not at its default bank: {fe}")
    if fe["acc_max_delta"] > 0.01:
        fail(f"fused vs cached eval disagree: acc_max_delta "
             f"{fe['acc_max_delta']} (bar 0.01)")
    for name in ("classify", "episode"):
        d = lines[name]["detail"]
        if d["frames_from"] != "eovc_raw" or d["arch"] != "resnet50":
            fail(f"{name} bench ran {d['frames_from']} / {d['arch']}")

    # The fused step's own features against the plain program.
    got = capture.found
    if "feats" not in got:
        fail(f"the fused eval bench's first step was not captured: "
             f"{sorted(got)}")
    fe_weights, fe_cfg = got["make"]
    clips = got["clips"]
    plain = make_feature_fn(fe_weights, dataclasses.replace(
        fe_cfg, compute_dtype="float32", fused_stages=(),
        pallas_crop=False), dev)(clips)
    kernels32 = make_feature_fn(fe_weights, dataclasses.replace(
        fe_cfg, compute_dtype="float32"), dev)(clips)
    cos = torch.nn.functional.cosine_similarity
    fused_cos = {
        "bench_bf16_vs_plain_f32": float(cos(got["feats"].float(), plain,
                                             dim=1).min()),
        "kernels_f32_vs_plain_f32": float(cos(kernels32, plain,
                                              dim=1).min())}
    if (tuple(got["feats"].shape) != (64, 2048)
            or not bool(torch.isfinite(got["feats"]).all())
            or fused_cos["bench_bf16_vs_plain_f32"] < 0.99
            or fused_cos["kernels_f32_vs_plain_f32"] < 0.99999):
        fail(f"the fused eval step's features disagree with the plain "
             f"program on its first 64 clips: {fused_cos} (bars 0.99 bf16, "
             f"0.99999 f32), shape {tuple(got['feats'].shape)}")
    del clips, plain, kernels32, capture

    buf = io.StringIO()
    from eov_tpu_torch.bench import decode

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        decode.main()
    dec = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
    for line in dec:
        print(json.dumps({"bench": "decode", "card": gpu, **line}),
              flush=True)
    dec_s = time.perf_counter() - t0
    raw = [x for x in dec if x["detail"]["path"] in ("eovc_raw",
                                                       "python_raw")
           and x["value"] is not None]
    if not raw or any(x["value"] is not None and not x["value"] > 0
                      for x in dec):
        fail(f"decode bench: no RAW rate, or a rate not > 0: {dec}")

    # fold_bn=False on the main path's 32 clips (256x320, kernel 1 crops):
    # the unfolded program against the folded one, bf16.
    weights = random_state_dict("resnet50", seed=0)
    cfg = ExtractConfig(num_segments=8, batch_clips=32)
    folded = make_feature_fn(weights, cfg, dev)
    unfolded = make_feature_fn(weights, dataclasses.replace(
        cfg, fold_bn=False), dev)
    since = Launches({"crop_normalize": crop_normalize.crop_normalize})
    a, b = unfolded(batch), folded(batch)
    unfolded_launches = since()
    if unfolded_launches["crop_normalize"] == 0:
        fail("the fold_bn=False program did not crop with kernel 1")
    cos = float(torch.nn.functional.cosine_similarity(a, b, dim=1).min())
    if not bool(torch.isfinite(a).all()) or cos < 0.999:
        fail(f"fold_bn=False features vs folded: min cosine {cos} "
             "(bar 0.999, bf16)")
    ms_unfolded = cuda_ms(lambda: unfolded(batch), repeats=5, inner=1)
    ms_folded = cuda_ms(lambda: folded(batch), repeats=5, inner=1)
    return {"gpu": gpu, "launches": launches,
            "fused_eval_acc_max_delta": fe["acc_max_delta"],
            "fused_eval_chunk_min_cosine_vs_plain": fused_cos,
            "decode_s": dec_s,
            "decode_rates": {x["detail"]["path"]: [x["value"],
                                                   x["detail"]["reader"]]
                             for x in dec},
            "fold_bn_false_cosine_vs_folded_min": cos,
            "fold_bn_false_launches": unfolded_launches,
            "feature_program_ms_per_32_clips": {
                "fold_bn_false": ms_unfolded, "folded_main": ms_folded}}


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


# ------------------------------------------------------------ multi-GPU

MULTI_TIMEOUT_S = 300  # one spawned group or one torchrun command


def _render(ds, items) -> list:
    """``ds.get_frames`` of each (record, indices), on 8 threads (numpy's
    array loops release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(lambda a: ds.get_frames(*a), items))


class _RenderedClips:
    """``main_path``'s 12 x 6 synthetic clips at 256x320, their 8 center
    frames rendered once into ``path`` (an .npz): a dataset for the ranks,
    which would otherwise each render them again."""

    def __init__(self, path: str):
        from eov_tpu_torch.data.datasets import SyntheticVideoDataset

        ds = SyntheticVideoDataset(n_classes=12, clips_per_class=6,
                                   height=256, width=320, seed=0)
        self.records, self.class_names = ds.records, ds.class_names
        if not os.path.exists(path):
            from eov_tpu_torch.data.segments import center_indices_np

            idx = np.stack([center_indices_np(r.num_frames, 8)
                            for r in ds.records])
            np.savez(path, idx=idx, frames=np.stack(_render(
                ds, list(zip(ds.records, idx)))))
        z = np.load(path)
        self.frames = z["frames"]
        self._pos = {r.video_id: (n, {int(f): p for p, f in enumerate(i)})
                     for n, (r, i) in enumerate(zip(ds.records, z["idx"]))}

    def get_frames(self, record, indices) -> np.ndarray:
        n, pos = self._pos[record.video_id]
        return self.frames[n, [pos[int(i)] for i in indices]]


def _multi_kernels():
    from eov_tpu_torch.ops import (bottleneck, bottleneck_int8,
                                   bottleneck_train, crop_normalize,
                                   similarity)

    return {"crop_normalize": crop_normalize.crop_normalize,
            "bottleneck_stack": bottleneck.fused_bottleneck_stack,
            "bottleneck_int8": bottleneck_int8.fused_bottleneck_stack_int8,
            "episode_scores": similarity.episode_class_scores,
            "bottleneck_train_fwd": bottleneck_train.train_stack_forward,
            "bottleneck_train_bwd": bottleneck_train.train_stack_backward}


def _virtual_bank(dev):
    """A seeded virtual support bank for the 12 classes (4 slots, masked
    by counts), the same in every process."""
    from eov_tpu_torch.eval import FeatureTable

    g = torch.Generator().manual_seed(5)
    return FeatureTable(torch.randn(12, 4, 2048, generator=g).to(dev),
                        torch.randint(0, 5, (12,), generator=g).to(dev))


def _multi_eval_cfgs():
    from eov_tpu_torch.eval import EvalConfig

    plain = EvalConfig(n_way=5, k_shot=1, n_query=1, n_episodes=600,
                       episodes_per_step=64)
    return {"plain": plain,
            "embodied": dataclasses.replace(plain, embodied=True)}


def _train_steps(cfg, dev, frames, labels, n_steps, mesh=None):
    """``n_steps`` steps of a fresh state on one fixed batch (keys 11..);
    the losses."""
    from eov_tpu_torch import prng
    from eov_tpu_torch import train as tr

    state = tr.create_train_state(cfg, dev)
    step = tr.make_train_step(cfg, dev, mesh=mesh)
    losses = []
    for i in range(n_steps):
        state, m = step(state, frames, labels, prng.key(11 + i))
        losses.append(float(m["loss"]))
    return losses


def _rank_work(rank: int, dev, work: str) -> dict:
    """One rank's part (a): sharded extraction at data = world and at
    frame 2 (where the world is even), int8 with rank 0's scales, the
    sharded eval (plain and embodied), the sharded train steps."""
    from eov_tpu_torch import train as tr
    from eov_tpu_torch.data.store import FeatureStore
    from eov_tpu_torch.extract import (ExtractConfig, extract_features,
                                       quant_calibration)
    from eov_tpu_torch.models.resnet import random_state_dict
    from eov_tpu_torch.parallel import distributed as pdist
    from eov_tpu_torch.parallel.mesh import make_mesh
    from eov_tpu_torch.parallel.sharded import evaluate_sharded

    kernels = _multi_kernels()
    since = Launches(kernels)
    world = pdist.world_size()
    ds = _RenderedClips(os.path.join(work, "clips.npz"))
    weights = random_state_dict("resnet50", seed=0)
    cfg = ExtractConfig(num_segments=8, batch_clips=32,
                        compute_dtype="bfloat16")  # tpu_batched
    meshes = {"data": make_mesh(world, 1)}
    if world % 2 == 0:
        meshes["frame2"] = make_mesh(world // 2, 2)
    res, secs = {"world": world}, {}
    for name, mesh in meshes.items():
        store = FeatureStore(os.path.join(work, name),
                             class_names=ds.class_names,
                             process_index=mesh.data_index, quant=None)
        t0 = time.perf_counter()
        res[f"stats_{name}"] = extract_features(ds, weights, store, cfg,
                                                device=dev, mesh=mesh)
        secs[f"extract_{name}"] = time.perf_counter() - t0
    cfg8 = dataclasses.replace(cfg, quant="int8")
    t0 = time.perf_counter()
    act = quant_calibration(weights, cfg8, device=dev) if rank == 0 else None
    act = pdist.broadcast_object(act)
    mesh = meshes["data"]
    store = FeatureStore(os.path.join(work, "int8"),
                         class_names=ds.class_names,
                         process_index=mesh.data_index, quant="int8")
    store.set_quant_calib(act)
    res["stats_int8"] = extract_features(ds, weights, store, cfg8,
                                         device=dev, act_max=act, mesh=mesh)
    res["act_max"] = act
    secs["extract_int8"] = time.perf_counter() - t0

    table = FeatureStore(os.path.join(work, "data")).to_table(dev)
    for name, ecfg in _multi_eval_cfgs().items():
        t0 = time.perf_counter()
        res[f"eval_{name}"] = evaluate_sharded(
            table, ecfg, mesh, virtual=_virtual_bank(dev)).per_episode
        secs[f"eval_{name}"] = time.perf_counter() - t0

    z = np.load(os.path.join(work, "train_batch.npz"))
    rows = pdist.host_local_rows(mesh, len(z["labels"]))
    frames = torch.from_numpy(z["frames"][rows])
    labels = torch.from_numpy(z["labels"][rows])
    t0 = time.perf_counter()
    res["train_bf16"] = _train_steps(tr.TrainConfig(), dev, frames, labels,
                                     3, mesh)
    res["train_f32"] = _train_steps(
        tr.TrainConfig(compute_dtype="float32"), dev, frames, labels, 1,
        mesh)
    secs["train"] = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    res["launches"] = since()
    res["s"] = secs
    return res


def _rank_main(rank: int, world: int, backend: str, port: int, dev_index: int,
               work: str) -> None:
    """A spawned rank: its process group, its part, its results file."""
    from eov_tpu_torch.models.folded_infer import use_full_f32
    from eov_tpu_torch.parallel import distributed as pdist

    dev = torch.device("cuda", dev_index)
    torch.cuda.set_device(dev)
    use_full_f32()
    torch.backends.cudnn.deterministic = True
    pdist.initialize(backend, init_method=f"tcp://localhost:{port}",
                     world_size=world, rank=rank, device=dev)
    res = _rank_work(rank, dev, work)
    torch.save(res, os.path.join(work, f"rank{rank}.pt"))
    pdist.barrier()
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_ranks(world: int, backend: str, work: str) -> list:
    """Start the ranks (spawn: CUDA cannot be forked); returns the
    processes."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    n_dev = torch.cuda.device_count()
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, backend, port, r if n_dev > 1 else 0, work), daemon=True)
        for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join_ranks(procs, work: str) -> list:
    """Join every rank within MULTI_TIMEOUT_S; a rank that fails or hangs
    fails the run (every rank is stopped first)."""
    deadline = time.perf_counter() + MULTI_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.perf_counter()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if hung or any(codes):
        fail(f"multi-GPU ranks failed: exit codes {codes}, hung {hung}")
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def _cos_min(a: np.ndarray, b: np.ndarray) -> float:
    return float(((a * b).sum(-1) / np.linalg.norm(a, axis=-1)
                  / np.linalg.norm(b, axis=-1)).min())


def _rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    """||a - b|| / ||b|| over a store's whole feature matrix [clips, D]:
    scale-sensitive, where a cosine is not. A wrong scale reads 0.5 or
    1.0; an error of at least e in every clip reads at least e."""
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# The sharded stores' bar on _rel_l2 against the single-GPU store, between
# what the sharded programs read and what their faults read: a wrong
# segment divisor scales every clip (0.5 or 1.0), and a frame rank that
# averages only its own half of the segments reads ``_half_segment_rel``
# (measured above the bar in every run, or the run fails: these synthetic
# clips' segments are close). On H100s (NVIDIA H100 80GB HBM3, 700 W) the
# bf16 stores read 2.2e-4 with 2 ranks sharing one card and 6.5e-4 with 4
# NCCL ranks on four (7.2e-4 and 7.6e-4 at the worst clip; int8 0), the
# half-segment mean 6.6e-3 (2.6e-3 at its nearest clip).
SHARDED_REL_BAR = 1e-3


def _half_segment_rel(ds, weights, cfg, dev) -> float:
    """The check's power against a missing frame all-reduce: _rel_l2 of
    the mean of the first K/2 segments against the mean of all K, over the
    single-GPU segment features of every clip."""
    from eov_tpu_torch.extract import make_segment_fn

    seg_fn = make_segment_fn(weights, cfg, dev)
    k, half, full = cfg.num_segments, [], []
    for i in range(0, len(ds.frames), cfg.batch_clips):
        with torch.inference_mode():
            seg = seg_fn(torch.from_numpy(ds.frames[i:i + cfg.batch_clips]))
        seg = seg.float().cpu().numpy()
        half.append(seg[:, :k // 2].mean(1))
        full.append(seg.mean(1))
    return _rel_l2(np.concatenate(half), np.concatenate(full))


def _hold_store(name: str, got: dict, want: dict, cos_bar: float,
                bit_equal: bool = False) -> dict:
    """A sharded store against the single-GPU extraction: the same clips
    and labels exactly; each clip at cosine >= ``cos_bar``, the store at
    _rel_l2 <= SHARDED_REL_BAR; with ``bit_equal``, every clip bit for
    bit. The readings are printed before any bar is held."""
    if set(got) != set(want) or any(got[v][1] != want[v][1] for v in want):
        fail(f"multi-GPU {name} store holds other clips or labels than the "
             f"single-GPU extraction ({len(got)} vs {len(want)} clips)")
    ids = sorted(want)
    a = np.stack([got[v][0] for v in ids])
    b = np.stack([want[v][0] for v in ids])
    res = {"clips": len(ids), "cosine_min": _cos_min(a, b),
           "rel_l2": _rel_l2(a, b), "rel_l2_bar": SHARDED_REL_BAR,
           "clip_rel_l2_max": float((np.linalg.norm(a - b, axis=-1)
                                     / np.linalg.norm(b, axis=-1)).max()),
           "max_abs_err": float(np.abs(a - b).max()),
           "bit_equal_clips": int(sum(np.array_equal(got[v][0], want[v][0])
                                      for v in ids))}
    print(json.dumps({f"multi_gpu_store_{name}": res}), flush=True)
    if res["cosine_min"] < cos_bar or res["rel_l2"] > SHARDED_REL_BAR:
        fail(f"multi-GPU {name} features disagree with the single-GPU "
             f"extraction: {res} (cosine bar {cos_bar})")
    if bit_equal and res["bit_equal_clips"] != len(ids):
        fail(f"multi-GPU {name} features: not every clip bit-equal to the "
             f"single-GPU extraction: {res}")
    return res


def _api_ranks(dev) -> dict:
    """Part (a): the API on spawned ranks against single-GPU runs on the
    same inputs."""
    from eov_tpu_torch import train as tr
    from eov_tpu_torch.data.datasets import SyntheticVideoDataset
    from eov_tpu_torch.data.store import FeatureStore, MemoryFeatureStore
    from eov_tpu_torch.eval import evaluate
    from eov_tpu_torch.extract import ExtractConfig, extract_features
    from eov_tpu_torch.models.resnet import random_state_dict

    work = os.path.join(WORK, "multi_gpu")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    n_dev = torch.cuda.device_count()
    world, backend = (2, "gloo") if n_dev == 1 else (min(n_dev, 4), "nccl")
    t0 = time.perf_counter()
    ds = _RenderedClips(os.path.join(work, "clips.npz"))
    tds = SyntheticVideoDataset(n_classes=64, clips_per_class=2, height=256,
                                width=320, seed=0)
    rng = np.random.default_rng(0)
    recs = [tds.records[i] for i in rng.permutation(len(tds.records))[:32]]
    items = [(r, tr._tsn_train_indices(rng, r.num_frames, 3)) for r in recs]
    np.savez(os.path.join(work, "train_batch.npz"),
             frames=np.stack(_render(tds, items)),
             labels=np.array([r.label for r in recs]))
    render_s = time.perf_counter() - t0
    print(json.dumps({"multi_gpu_ranks": {
        "backend": backend, "world": world,
        "ranks_per_device": world if n_dev == 1 else 1}}), flush=True)

    t0 = time.perf_counter()
    procs = _spawn_ranks(world, backend, work)
    # The single-GPU runs on the same inputs, while the ranks work.
    weights = random_state_dict("resnet50", seed=0)
    cfg = ExtractConfig(num_segments=8, batch_clips=32,
                        compute_dtype="bfloat16")
    single = MemoryFeatureStore(class_names=ds.class_names)
    extract_features(ds, weights, single, cfg, device=dev)
    half_rel = _half_segment_rel(ds, weights, cfg, dev)
    print(json.dumps({"multi_gpu_half_segment_rel_l2": half_rel}),
          flush=True)
    z = np.load(os.path.join(work, "train_batch.npz"))
    frames, labels = torch.from_numpy(z["frames"]), torch.from_numpy(
        z["labels"])
    # train_path's setting (cuDNN free to pick nondeterministic
    # algorithms), twice: its run-to-run spread.
    rerun = [_train_steps(tr.TrainConfig(), dev, frames, labels, 3)
             for _ in range(2)]
    torch.backends.cudnn.deterministic = True  # as the ranks run
    try:
        bf16 = _train_steps(tr.TrainConfig(), dev, frames, labels, 3)
        f32 = _train_steps(tr.TrainConfig(compute_dtype="float32"), dev,
                           frames, labels, 1)
    finally:
        torch.backends.cudnn.deterministic = False
    ranks = _join_ranks(procs, work)
    group_s = time.perf_counter() - t0

    r0 = ranks[0]
    zero = {n: c for n, c in r0["launches"].items() if c == 0}
    if zero:
        fail(f"kernels never launched on the multi-GPU path: {zero}")
    want = single.load_all()
    out = {"backend": backend, "world": world, "render_s": render_s,
           "group_s": group_s, "rank0_s": r0["s"],
           "launches_rank0": r0["launches"],
           "half_segment_rel_l2": half_rel}
    for name in ("data", "frame2"):
        if f"stats_{name}" in r0:
            out[f"extract_{name}"] = _hold_store(
                name, FeatureStore(os.path.join(work, name)).load_all(),
                want, 0.99)
    if half_rel <= SHARDED_REL_BAR:
        fail(f"a half-segment mean reads {half_rel} <= the sharded stores' "
             f"bar {SHARDED_REL_BAR}: the check could not catch it")
    act = r0["act_max"]
    if any(r["act_max"] != act for r in ranks):
        fail("multi-GPU int8: the ranks quantized with different scales")
    single8 = MemoryFeatureStore(class_names=ds.class_names)
    extract_features(ds, weights, single8, dataclasses.replace(
        cfg, quant="int8"), device=dev, act_max=act)
    out["extract_int8"] = _hold_store(
        "int8", FeatureStore(os.path.join(work, "int8")).load_all(),
        single8.load_all(), 0.99, bit_equal=True)

    table = FeatureStore(os.path.join(work, "data")).to_table(dev)
    for name, ecfg in _multi_eval_cfgs().items():
        ref = evaluate(table, ecfg, virtual=_virtual_bank(dev)).per_episode
        for r in ranks:
            if not np.array_equal(r[f"eval_{name}"], ref):
                fail(f"multi-GPU {name} eval: per_episode differs from the "
                     f"single-GPU evaluate in "
                     f"{int((r[f'eval_{name}'] != ref).sum())} of 600")
        out[f"eval_{name}"] = {"per_episode_bit_equal": True,
                               "mean_acc": float(ref.mean())}

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    f32_rel = max(rel(r["train_f32"], f32) for r in ranks)
    if f32_rel > 1e-4:
        fail(f"multi-GPU f32 train step: loss rel {f32_rel} > 1e-4 against "
             "the single-GPU step")
    # bf16: the train parity tests' bar. Sharding reorders the stem BN's
    # and the gradients' sums; the single-GPU step itself repeats bit for
    # bit (train_path_rerun_loss_rel_bf16 beside it).
    bf16_rel = max(rel(r["train_bf16"], bf16) for r in ranks)
    rerun_rel = rel(rerun[1], rerun[0])
    if not bf16_rel <= 1e-4:
        fail(f"multi-GPU bf16 train steps: loss rel {bf16_rel} > 1e-4 "
             "against the single-GPU steps")
    out["train"] = {"losses_bf16": r0["train_bf16"],
                    "losses_bf16_single": bf16,
                    "loss_rel_bf16": bf16_rel,
                    "train_path_rerun_loss_rel_bf16": rerun_rel,
                    "losses_bf16_rerun": rerun,
                    "loss_f32": r0["train_f32"], "loss_f32_single": f32,
                    "loss_rel_f32": f32_rel}
    return out


def _cli_args(work: str) -> dict:
    """Part (b)'s command lines: the clips of extract (12, one full batch
    with and without --multichip), eval's protocol, train's run."""
    syn = ["--device", "cuda", "--synthetic-height", "256",
           "--synthetic-width", "320"]
    return {"clips": [*syn, "--preset", "tpu_batched", "--synthetic-classes",
                      "6", "--synthetic-clips", "2", "--batch", "12"],
            "eval": ["--preset", "tpu_batched", "--device", "cuda",
                     "--n-episodes", "600"],
            "train": [*syn, "--synthetic-classes", "4", "--synthetic-clips",
                      "2", "--batch", "4"],
            "multi": os.path.join(work, "multi"),
            "single": os.path.join(work, "single"),
            "run": os.path.join(work, "run")}


def _torchrun_chain(work: str) -> dict:
    """Part (b)'s torchrun commands in turn (extract --multichip -> eval
    --multichip -> train --multichip, one rank a card over NCCL):
    {command: (seconds, stdout lines)}. A command that fails or outlasts
    MULTI_TIMEOUT_S fails the run, its ranks killed with it (its
    session)."""
    a = _cli_args(work)
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(min(torch.cuda.device_count(), 4)), "-m",
           "eov_tpu_torch.cli"]
    steps = (("extract", ["extract", "--multichip", *a["clips"], "--store",
                          a["multi"]]),
             ("eval", ["eval", "--multichip", *a["eval"], "--store",
                       a["multi"]]),
             ("train", ["train", "--multichip", *a["train"], "--out",
                        a["run"], "--epochs", "1"]))
    env = dict(os.environ, PYTHONPATH=ROOT)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    done = {}
    for name, argv in steps:
        t0 = time.perf_counter()
        p = subprocess.Popen(run + argv, env=env, cwd=ROOT, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             start_new_session=True)
        try:
            out, err = p.communicate(timeout=MULTI_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, 9)
            p.communicate()
            fail(f"torchrun {name} --multichip did not finish in "
                 f"{MULTI_TIMEOUT_S} s")
        if p.returncode:
            fail(f"torchrun {name} --multichip exited {p.returncode}: "
                 f"{err[-2000:]}")
        done[name] = (time.perf_counter() - t0, out.strip().splitlines())
    return done


def _cli_ranks(work: str) -> dict:
    """Part (b): the torchrun commands, then ``test`` of the run, and the
    multichip store's accuracy against a store written without
    --multichip."""
    a = _cli_args(work)
    chain = _torchrun_chain(work)
    t0 = time.perf_counter()
    test = json.loads(_quiet_cli(["test", *a["train"], "--params",
                                  a["run"]])[-1])
    _quiet_cli(["extract", *a["clips"], "--store", a["single"]])
    acc_single = _quiet_cli(["eval", *a["eval"], "--store", a["single"]])[-1]
    secs = {name: sec for name, (sec, _) in chain.items()}
    secs["test_and_single_gpu"] = time.perf_counter() - t0
    acc_multi = chain["eval"][1][-1]
    if acc_multi != acc_single or not acc_multi.startswith("accuracy"):
        fail(f"eval of the --multichip store ({acc_multi!r}) differs from "
             f"the store written without it ({acc_single!r})")
    if test["n"] != 8:
        fail(f"test after train --multichip: {test}")
    return {"nproc_per_node": min(torch.cuda.device_count(), 4),
            "backend": "nccl", "s": secs,
            "extract": chain["extract"][1][-1], "eval": acc_multi,
            "eval_single_gpu_store": acc_single,
            "train": chain["train"][1][-2:], "test": test}


def _harness_check() -> dict | None:
    """Part (c): the parity harness's self-check, pipeline B on the card
    (PIL decides: without it the harness cannot run pipeline A)."""
    try:
        import PIL  # noqa: F401
    except ImportError as e:
        print(json.dumps({"parity_harness": None,
                          "reason": f"PIL does not import here: {e}"}),
              flush=True)
        return None
    from argparse import Namespace

    from eov_tpu_torch.tools import parity_harness as ph

    rep = ph.run(Namespace(params=None, root=None, split=None, classes=4,
                           clips_per_class=2, num_segments=2, scale=128,
                           crop=112, dtype="float32", n_episodes=50, seed=0,
                           device="cuda"))
    if rep["feature_cosine_min"] < 0.999 or not rep["within_budget"]:
        fail(f"parity harness self-check failed on the card: {rep}")
    return rep


def multi_gpu_path(dev, gpu) -> dict:
    """(a) the multi-GPU API on spawned ranks, (b) the CLI under torchrun
    over NCCL, (c) the parity harness, in turn; each part's seconds beside
    the card."""
    out = {}
    t0 = time.perf_counter()
    out["a_api_ranks"] = _api_ranks(dev)
    print(json.dumps({"multi_gpu_part": "a_api_ranks",
                      "s": time.perf_counter() - t0, "gpu": gpu}), flush=True)
    t0 = time.perf_counter()
    out["b_cli_torchrun"] = _cli_ranks(os.path.join(WORK, "multi_gpu_cli"))
    print(json.dumps({"multi_gpu_part": "b_cli_torchrun",
                      "s": time.perf_counter() - t0, "gpu": gpu}), flush=True)
    t0 = time.perf_counter()
    out["c_parity_harness"] = _harness_check()
    print(json.dumps({"multi_gpu_part": "c_parity_harness",
                      "s": time.perf_counter() - t0, "gpu": gpu}), flush=True)
    return out


def _planted_gaps(dev, sleep_s: float, n: int) -> dict:
    """``n`` launches of known kernels, each followed by a host-only span
    that sleeps ``sleep_s``: the root's ``device_gap_s`` against the idle
    planted (each host-only stretch less the kernel time still queued when
    it began)."""
    from eov_tpu_torch.utils import trace

    a = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)

    def kernels():
        for _ in range(4):
            a @ a

    kernels()
    kernel_ms = cuda_ms(kernels, repeats=9, inner=1)
    torch.cuda.synchronize()
    stretches = []
    with trace.root("smoke.gaps", 0, dev) as r:
        for _ in range(n):
            with trace.span("smoke.launch", device=True) as launch:
                kernels()
            with trace.span("smoke.sleep") as host:
                time.sleep(sleep_s)
            stretches.append((launch.t0, host.t0))
        torch.cuda.synchronize()
    rep = r.report
    # stretch i: from the sleep's start to the next launch (the root's end)
    ends = [s[0] for s in stretches[1:]] + [r.t1]
    host_s = [e - s[1] for s, e in zip(stretches, ends)]
    queued = [max(kernel_ms / 1e3 - (h - t0), 0.0) for t0, h in stretches]
    planted = sum(host_s) - sum(queued)
    got = rep["device_gap_s"]
    return {"sleep_s": sleep_s, "n": n, "kernel_ms": kernel_ms,
            "planted_s": planted, "device_gap_s": got,
            "rel_err": abs(got - planted) / planted,
            "by_span": rep["device_gap_by_span"]}


def _span_cost_us(dev, n: int = 20000) -> dict:
    """Host microseconds of the always-on path inside a root on the card:
    a host-only span, a device span after a device span (no event), a
    host-only stretch between device spans (its two events and their
    reading), ``count``, ``step``."""
    from eov_tpu_torch.utils import trace

    def per(fn) -> float:
        best = float("inf")
        for _ in range(5):
            t = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t) / n * 1e6)
        return best

    def host():
        for _ in range(n):
            with trace.span("cost.host"):
                pass

    def device():
        for _ in range(n):
            with trace.span("cost.device", device=True):
                pass

    def pair():
        for _ in range(n):
            with trace.span("cost.device", device=True):
                pass
            with trace.span("cost.host"):
                pass

    def counts():
        for _ in range(n):
            trace.count("cost.bytes", 3)

    def steps():
        for _ in range(n):
            trace.step()

    def empty():
        for _ in range(n):
            pass

    with trace.root("smoke.cost", 0, dev):
        base = per(empty)
        out = {"host_span": per(host) - base,
               "device_span": per(device) - base,
               "pair": per(pair) - base,
               "count": per(counts) - base, "step": per(steps) - base}
    out["stretch"] = out["pair"] - out["host_span"] - out["device_span"]
    return out


def _step_cost_us(dev, epochs: int = 20, steps: int = 16,
                  repeats: int = 15, tsm: bool = False) -> dict:
    """Host microseconds a train step spends in ``utils/trace.py``: epochs
    of empty steps with ``r50_finetune``'s spans and counts (32 clip reads
    and their two counts each, the batch, the step, five device spans, the
    three ``train.keys`` stretches inside the augment: the key split, the
    crop draws, the dropout seed; the images, and the six launches each of
    kernels 8 and 9), the roots' events read and reports folded; the least
    of ``repeats`` blocks (the shared host's other work only adds to a
    block); and one such epoch's report. ``tsm`` adds what
    ``tsm_nl_resnet50`` adds a step: five timed ``model.nonlocal`` spans in
    the forward and five in the backward (two events each, read at the
    root's end), and the shift's 32 launch counts."""
    from eov_tpu_torch.utils import trace

    def nonlocal_spans():
        for _ in range(5):
            with trace.span("model.nonlocal", device=True, timed=True):
                pass

    def epoch(e):
        with trace.root("smoke.epoch", e, dev) as r:
            for _ in range(steps):
                for _ in range(32):
                    with trace.span("read"):
                        trace.count("eovc.bytes", 1)
                        trace.count("eovc.clips")
                with trace.span("train.batch"):
                    pass
                with trace.span("train.step"):
                    with trace.span("train.h2d", device=True):
                        pass
                    trace.count("train.images", 96)
                    with trace.span("train.augment", device=True):
                        for _ in range(3):
                            with trace.span("train.keys"):
                                pass
                    with trace.span("train.forward", device=True):
                        for _ in range(6):
                            trace.count("launch.train_stack_forward")
                        if tsm:
                            for _ in range(32):
                                trace.count("launch.temporal_shift")
                            nonlocal_spans()
                    with trace.span("train.backward", device=True):
                        for _ in range(6):
                            trace.count("launch.train_stack_backward")
                        if tsm:
                            nonlocal_spans()
                    with trace.span("train.optimizer", device=True):
                        pass
                trace.step()
        return r.report

    best = float("inf")
    for _ in range(repeats):
        t = time.perf_counter()
        for e in range(epochs):
            rep = epoch(e)
        best = min(best, (time.perf_counter() - t) / (epochs * steps) * 1e6)
    return {"us_per_step": best, "report": rep}


def trace_path(dev, gpu) -> dict:
    """``utils/trace.py`` on the card: the planted 5 ms gaps read back
    within 10%; a root under torch.profiler reports itself profiled; the
    always-on cost per span, on and off the profiler, and per train step
    (empty steps with ``r50_finetune``'s spans and counts), printed beside
    the 50 us budget (``over_budget_us``: four host-only stretches a step,
    each two timing events and a read, exceed it on the card's host)."""
    from torch.profiler import ProfilerActivity, profile

    from eov_tpu_torch.utils import trace

    gaps = _planted_gaps(dev, 0.005, 20)
    if not gaps["rel_err"] <= 0.10:
        fail(f"device_gap_s {gaps['device_gap_s']} s against the planted "
             f"{gaps['planted_s']} s: {gaps}")
    if gaps["by_span"].get("smoke.sleep", 0.0) < 0.9 * gaps["planted_s"]:
        fail(f"the planted gaps are not put down to smoke.sleep: {gaps}")
    off = _span_cost_us(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]):
        on = _span_cost_us(dev, n=2000)
        with trace.root("smoke.profiled", 0, dev) as r:
            pass
    if not r.report["profiled"]:
        fail("a root under torch.profiler does not report it profiled")
    step = _step_cost_us(dev)
    tsm = _step_cost_us(dev, tsm=True)
    if tsm["report"]["spans"]["model.nonlocal"]["n"] != 16 * 10 or not (
            tsm["report"]["device_span_s"]["model.nonlocal"] >= 0):
        fail(f"the timed non-local spans: {tsm['report']}")
    out = {"gpu": gpu, "planted_gaps": gaps, "span_cost_us_off": off,
           "span_cost_us_profiled": on,
           "cost_us_per_step": step["us_per_step"],
           "cost_us_per_step_tsm": tsm["us_per_step"],
           "tsm_adds_us_per_step": tsm["us_per_step"] - step["us_per_step"],
           "over_budget_us": max(step["us_per_step"] - 50.0, 0.0),
           "step_report": step["report"]}
    # four host-only stretches a step (the loop, and in the augment the key
    # split, the crop draws, the dropout seed), and the epoch's last
    if step["report"]["device_gap_n"] != 16 * 4 + 1:
        fail(f"the steps' host-only stretches: {step['report']}")
    return out


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

    t_start = t0 = time.perf_counter()

    def phase(name):
        nonlocal t0
        now = time.perf_counter()
        print(json.dumps({"phase": name, "s": now - t0,
                          "total_s": now - t_start}), flush=True)
        t0 = now

    only = {"multi_gpu_path": multi_gpu_path, "trace_path": trace_path,
            "tsm_ops": tsm_ops}
    name = (sys.argv[2:3] or [""])[0] if sys.argv[1:2] == ["--only"] else None
    if name not in (None, *only):
        fail(f"--only takes one of {sorted(only)}, not {name!r}")
    if name != "trace_path":  # the trace phase launches no kernel of ours
        per_source = _cuda.build_all()
        build_s = time.perf_counter() - t0
        print(json.dumps({"build_s": build_s, "nvcc_s": per_source}),
              flush=True)
        phase("build")
    if name is not None:  # a quick re-check of one phase
        print(json.dumps({name: only[name](dev, gpu)}), flush=True)
        phase(name)
        print(card_line(), flush=True)
        return 0

    rows = []
    for check in (check_crop, check_stack, check_matcher, check_int8_stack,
                  check_train_stack, check_pool, check_basic_stack,
                  check_pool_stack, check_shift):
        found = check(dev)
        for row in found if isinstance(found, list) else [found]:
            row["gpu"] = gpu
            print(json.dumps({"kernel": row["name"], "kernel_ms": row["ms"],
                              **row}), flush=True)
            rows.append(row)
        phase(check.__name__)
    print(json.dumps({"nonlocal_attention": nonlocal_times(dev)}),
          flush=True)
    phase("nonlocal_times")

    summary, acc_line, batch = main_path(dev, gpu)
    print(json.dumps({"main_path": summary}), flush=True)
    print(acc_line, flush=True)
    phase("main_path")
    print(json.dumps({"real_data_path": real_data_path(dev, gpu)}),
          flush=True)
    phase("real_data_path")
    int8 = int8_embodied_path(dev, gpu, batch)
    print(json.dumps({"int8_embodied_path": int8}), flush=True)
    phase("int8_embodied_path")
    basic = basic_pool_path(dev, gpu, batch)
    print(json.dumps({"basic_pool_path": basic}), flush=True)
    phase("basic_pool_path")
    train = train_path(dev, gpu)
    print(json.dumps({"train_path": train}), flush=True)
    phase("train_path")
    print(json.dumps({"gpu_vs_cpu_f32_train_step": gpu_vs_cpu_step(dev)}),
          flush=True)
    phase("gpu_vs_cpu_step")
    print(json.dumps({"bench_path": bench_path(
        dev, gpu, summary["feature_program_ms_per_32_clips"])}), flush=True)
    phase("bench_path")
    print(json.dumps({"train_levers_path": train_levers_path(dev, gpu)}),
          flush=True)
    phase("train_levers_path")
    print(json.dumps({"deploy_bench_path": deploy_bench_path(
        dev, gpu, batch)}), flush=True)
    del batch
    phase("deploy_bench_path")
    print(json.dumps({"multi_gpu_path": multi_gpu_path(dev, gpu)}),
          flush=True)
    phase("multi_gpu_path")
    print(json.dumps({"trace_path": trace_path(dev, gpu)}), flush=True)
    phase("trace_path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    new = ("basic_stack", "maxpool_s2", "pool_bottleneck_stack")
    launches = {**summary["launches"], **train["launches"],
                "bottleneck_int8": int8["launches"]["bottleneck_int8"],
                **{k: basic["launches"][k] for k in new}}
    for row in rows:
        row["launches"] = launches.get(row["name"], row.get("launches"))
    print(json.dumps({"kernels": [
        {k: row[k] for k in keys + ("note",) if k in row} for row in rows]}),
        flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
