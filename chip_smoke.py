"""GPU smoke test of eov_tpu_torch's main path: build, check, run, report.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card (``nvidia-smi --query-gpu=name,power.limit``);
2. build the three CUDA kernels from ``eov_tpu_torch/csrc/`` (one nvcc per
   source, in parallel) and time the build;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, and time kernel, plain version and, where one
   PyTorch call computes the function, that call (CUDA events, median of
   repeats; the microsecond kernels replayed from a CUDA graph);
4. run the main path: a synthetic dataset stored at 256x320 (so the crop
   kernel runs), full-width ResNet-50 with seeded random weights, K=8,
   32 clips per batch, bf16 -> ``extract_features`` into a store ->
   600 5-way 1-shot episodes with ``evaluate``; every kernel's launch count
   over that run must be non-zero, and the results are checked against the
   port's plain CPU path;
5. print the ``kernels`` JSON line, the card line, and last
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
    for check in (check_crop, check_stack, check_matcher):
        row = check(dev)
        row["gpu"] = gpu
        print(json.dumps({"kernel": row["name"], "kernel_ms": row["ms"],
                          **row}), flush=True)
        rows.append(row)

    summary, acc_line = main_path(dev, gpu)
    print(json.dumps({"main_path": summary}), flush=True)
    print(acc_line, flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for row in rows:
        row["launches"] = summary["launches"][row["name"]]
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
