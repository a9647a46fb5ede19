"""Feature bench: clip-feature throughput of the feature program (clips/s).

Counterpart of the reference's ``bench.py``: 8-frame TSN clip features of
uint8 frames already on the device, through ``make_feature_fn`` (kernel 1's
crop + normalize when the frames are stored at the eval scale, the folded
ResNet with its fused stages on kernel 2, the TSN mean), seeded random
weights. Prints ONE JSON line with ``bench.py``'s schema: ``metric``
``<arch>_clip_features_throughput``, ``value`` in clips/s, ``unit``
``clips/sec/gpu``, ``vs_baseline`` (value / 1000) and ``detail``.

Timing: the first call builds nothing new (the kernels are built before
it, ``detail.build_s``) and warms up, untimed. A window is ``window``
back-to-back calls between two CUDA events and one synchronize; a repeat is
the median of ``iters`` windows; the value is the median over repeats,
with the repeats' min, max and spread beside it. FLOPs are the analytic
backbone count (``utils/flops.py``) at the 224x224 crop; ``mfu`` divides
the achieved rate by the card's dense bf16 peak (int8 peak under
``EOV_BENCH_QUANT=int8``, FLOPs still counted as bf16-equivalent).

Knobs (``bench.py``'s names, defaults and refusals; defaults keyed on the
device being ``cuda`` where ``bench.py`` keys them on a TPU):
``EOV_BENCH_DEVICE`` (cuda | cpu), ``EOV_BENCH_ARCH`` (resnet50),
``EOV_BENCH_BATCH`` (64 | 2 clips), ``EOV_BENCH_ITERS`` (4 | 2),
``EOV_BENCH_WINDOW`` (64 | 2), ``EOV_BENCH_FRAME_HW`` (224x224: the
production storage size, normalize only; 256x320 with
``EOV_BENCH_SCALE=256`` crops on the card), ``EOV_BENCH_SCALE`` (224),
``EOV_BENCH_S2D`` (0), ``EOV_BENCH_FUSED_STAGES`` (auto | none | 1,2,..),
``EOV_BENCH_PALLAS_CROP`` (1; 0 = the resize path),
``EOV_BENCH_FUSED_GROUP`` (2; a no-op in the port),
``EOV_BENCH_PALLAS_POOL`` (0 | 1 = kernel 6 | fused = kernel 5),
``EOV_BENCH_QUANT`` (0 | int8), ``EOV_BENCH_REPEATS`` (5 | 1),
``EOV_BENCH_TRACE`` (a directory: trace the timed windows).

A kernel that fails to build or launch ends the bench with an error; there
is no fallback to another path.
"""

from __future__ import annotations

import os
import statistics

import numpy as np
import torch

from eov_tpu_torch.bench.common import (bench_device, build_kernels, card,
                                        emit, env_default, mfu_fields,
                                        step_seconds, traced)

__all__ = ["main"]


def _fused_stages(fused_env: str | None):
    if fused_env is None or fused_env == "auto":
        return "auto"
    try:
        return tuple(int(v) for v in fused_env.replace("none", "").split(",")
                     if v)
    except ValueError:
        raise SystemExit(
            f"EOV_BENCH_FUSED_STAGES={fused_env!r}: expected 'auto', "
            "'none', or a comma-separated stage list like '1' or '1,2'"
        ) from None


def main() -> None:
    from eov_tpu_torch.extract import ExtractConfig, make_feature_fn
    from eov_tpu_torch.models.folded_infer import resolve_fused_stages
    from eov_tpu_torch.models.resnet import random_state_dict
    from eov_tpu_torch.utils.flops import resnet_forward_flops

    dev = bench_device()
    arch = os.environ.get("EOV_BENCH_ARCH", "resnet50")
    batch = int(env_default("EOV_BENCH_BATCH", "64", "2", dev))
    iters = int(env_default("EOV_BENCH_ITERS", "4", "2", dev))
    window = int(env_default("EOV_BENCH_WINDOW", "64", "2", dev))
    repeats = int(env_default("EOV_BENCH_REPEATS", "5", "1", dev))
    hw = tuple(int(v) for v in
               os.environ.get("EOV_BENCH_FRAME_HW", "224x224").split("x"))
    scale = int(os.environ.get("EOV_BENCH_SCALE", "224"))
    k = 8
    s2d = os.environ.get("EOV_BENCH_S2D", "0") == "1"
    fused_env = os.environ.get("EOV_BENCH_FUSED_STAGES")
    fused = _fused_stages(fused_env)
    pcrop = os.environ.get("EOV_BENCH_PALLAS_CROP", "1") == "1"
    fgroup = int(os.environ.get("EOV_BENCH_FUSED_GROUP", "2"))
    ppool_env = os.environ.get("EOV_BENCH_PALLAS_POOL", "0")
    if ppool_env not in ("0", "1", "fused"):
        raise SystemExit(
            f"EOV_BENCH_PALLAS_POOL={ppool_env!r}: accepted forms are "
            "0 (cuDNN max-pool), 1 (kernel 6), fused (pooled inside the "
            "stage-1 stack, kernel 5)")
    ppool = "fused" if ppool_env == "fused" else ppool_env == "1"
    quant_env = os.environ.get("EOV_BENCH_QUANT", "0")
    if quant_env not in ("0", "int8"):
        raise SystemExit(
            f"EOV_BENCH_QUANT={quant_env!r}: accepted forms are 0 (the bf16 "
            "production path) and int8")
    quant = "int8" if quant_env == "int8" else None
    if quant and (s2d or ppool):
        raise SystemExit(
            "EOV_BENCH_QUANT=int8 runs the int8 conv walk; unset "
            "EOV_BENCH_S2D / EOV_BENCH_PALLAS_POOL so the variant label "
            "cannot mix paths")
    if quant and fused_env not in (None, "auto", "none", "1"):
        raise SystemExit(
            "EOV_BENCH_QUANT=int8 composes only with "
            "EOV_BENCH_FUSED_STAGES=1 (the int8 fused stage-1 stack, kernel "
            f"7); got {fused_env!r}")
    # Under int8, 'auto' is the pure int8 walk and '1' the kernel-7 stack,
    # as the reference's bench selects them.
    quant_stages = (1,) if quant and fused_env == "1" else ()
    stages = (quant_stages if quant
              else resolve_fused_stages(fused, arch=arch))
    if ppool == "fused" and 1 not in stages:
        raise SystemExit(
            "EOV_BENCH_PALLAS_POOL=fused pools inside the stage-1 stack "
            f"kernel, which requires stage 1 fused (EOV_BENCH_FUSED_STAGES="
            f"{fused!r} resolved to {stages}); use EOV_BENCH_PALLAS_POOL=1 "
            "for the standalone kernel")
    try:
        cfg = ExtractConfig(
            num_segments=k, arch=arch, batch_clips=batch, scale_size=scale,
            crop_size=224, stem_s2d=s2d,
            fused_stages=quant_stages if quant else fused,
            pallas_crop=pcrop, fused_group=fgroup, pallas_pool=ppool,
            quant=quant)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    crop_active = pcrop and min(hw) == scale
    variant = (("crop_kernel" if crop_active else "resize") + "+fold_bn"
               + ("+s2d" if s2d else "")
               + (f"+fs{''.join(map(str, stages))}" if stages else "")
               + ("+poolfs" if ppool == "fused"
                  else "+ppool" if ppool is True else "")
               + ("+int8" if quant else ""))

    build_s = build_kernels(dev)
    fn = make_feature_fn(random_state_dict(arch, seed=0), cfg, dev)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(
        rng.integers(0, 256, (batch, k, *hw, 3), dtype=np.uint8)).to(dev)
    out = fn(frames)  # warm-up, untimed
    if not bool(torch.isfinite(out).all()):
        raise SystemExit("feature bench: non-finite features")

    repeat_cps = []
    with traced("EOV_BENCH_TRACE", dev):
        for _ in range(max(1, repeats)):
            steps = [step_seconds(lambda: fn(frames), window, dev)
                     for _ in range(iters)]
            repeat_cps.append(batch / statistics.median(steps))

    step_flops = batch * k * resnet_forward_flops(arch, (224, 224))
    clips_per_sec = statistics.median(repeat_cps)
    med = batch / clips_per_sec
    emit({
        "metric": f"{arch}_clip_features_throughput",
        "value": round(clips_per_sec, 2),
        "unit": "clips/sec/gpu",
        "vs_baseline": round(clips_per_sec / 1000.0, 4),
        "detail": {
            "device": dev.type,
            "gpu": card(dev),
            "arch": arch,
            "variant": variant,
            "batch_clips": batch,
            "num_segments": k,
            "frame_hw": list(hw),
            "median_step_s": round(med, 6),
            "step_tflops": round(step_flops / 1e12, 3),
            "effective_tflops_per_s": round(step_flops / med / 1e12, 2),
            **mfu_fields(step_flops / med, dev, int8=quant is not None),
            "flops_source": "analytic_backbone",
            "quant": quant,
            "fused_group": fgroup,
            "window": window,
            "iters": iters,
            "repeats": len(repeat_cps),
            "clips_per_sec_min": round(min(repeat_cps), 2),
            "clips_per_sec_max": round(max(repeat_cps), 2),
            "spread_pct": round(100.0 * (max(repeat_cps) - min(repeat_cps))
                                / clips_per_sec, 2),
            "build_s": build_s,
        },
    })


if __name__ == "__main__":
    main()
