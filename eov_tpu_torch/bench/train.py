"""Train bench: TSN finetune step throughput (clips/s).

Counterpart of the reference's ``bench_train.py``: the port's
``make_train_step`` (multiscale crops -> ResNet-50 forward and backward,
stage 1 and the stage-2 tail on kernels 8 and 9 on the card -> consensus
cross-entropy -> SGD) on one fixed batch of uint8 frames already on the
device, the ``TrainConfig`` defaults with 64 classes and seeded random
weights. Prints ONE JSON line: ``metric`` ``tsn_finetune_step_throughput``,
``value`` in clips/s.

Timing: one warm-up window, untimed; then ``iters`` windows of ``window``
steps, each between two CUDA events and one synchronize. The state carries
from step to step (each step updates the weights), and each step draws its
crops from its own key, as the reference's scan does. The value is the
median window's rate, with the fastest and slowest beside it.
``step_tflops_model`` is 3x the analytic forward (``utils/flops.py``) at the
crop size; ``mfu`` divides it by the card's dense bf16 peak.

Knobs (the reference's names; defaults on ``cuda`` | elsewhere):
``EOV_BENCH_DEVICE`` (cuda | cpu), ``EOV_TRAIN_BATCH`` (32 | 2 clips),
``EOV_TRAIN_K`` (3), ``EOV_TRAIN_ITERS`` (6 | 2), ``EOV_TRAIN_WINDOW``
(16 | 1), ``EOV_TRAIN_S2D`` / ``EOV_TRAIN_POOL_VJP`` (auto),
``EOV_TRAIN_TRACE`` (a directory: trace the timed windows). Frames are
256x320 cropped to 224 in bf16 on the card, 40x48 cropped to 32 in f32
elsewhere, as the reference's bench sizes them off the TPU.
"""

from __future__ import annotations

import math
import os
import statistics

import numpy as np
import torch

from eov_tpu_torch.bench.common import (bench_device, build_kernels, card,
                                        emit, env_default, mfu_fields,
                                        step_seconds, traced)

__all__ = ["main"]


def main() -> None:
    from eov_tpu_torch import prng
    from eov_tpu_torch import train as tr
    from eov_tpu_torch.utils.flops import resnet_forward_flops

    dev = bench_device()
    on_cuda = dev.type == "cuda"
    batch = int(env_default("EOV_TRAIN_BATCH", "32", "2", dev))
    k = int(os.environ.get("EOV_TRAIN_K", "3"))
    iters = int(env_default("EOV_TRAIN_ITERS", "6", "2", dev))
    window = int(env_default("EOV_TRAIN_WINDOW", "16", "1", dev))
    hw = (256, 320) if on_cuda else (40, 48)
    scale, crop = (256, 224) if on_cuda else (36, 32)
    try:
        cfg = tr.TrainConfig(
            num_classes=64, num_segments=k, batch_clips=batch,
            scale_size=scale, crop_size=crop,
            compute_dtype="bfloat16" if on_cuda else "float32",
            stem_s2d=os.environ.get("EOV_TRAIN_S2D", "auto"),
            pool_vjp=os.environ.get("EOV_TRAIN_POOL_VJP", "auto"))
        tr.resolve_fused(cfg, dev)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(f"train bench: {e}") from None

    build_s = build_kernels(dev)
    state = tr.create_train_state(cfg, dev)
    step = tr.make_train_step(cfg, dev)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(
        rng.integers(0, 256, (batch, k, *hw, 3), dtype=np.uint8)).to(dev)
    labels = torch.from_numpy(
        rng.integers(0, cfg.num_classes, size=batch).astype(np.int64)).to(dev)

    key = prng.key(1)
    loss = None

    def one_step():
        nonlocal state, key, loss
        key, sub = prng.split(key, 2).unbind(0)
        state, m = step(state, frames, labels, sub)
        loss = m["loss"]

    step_seconds(one_step, window, dev)  # warm-up window, untimed
    with traced("EOV_TRAIN_TRACE", dev):
        win_times = [step_seconds(one_step, window, dev)
                     for _ in range(iters)]
    loss = float(loss)
    if not math.isfinite(loss):
        raise SystemExit(f"train bench: the loss is {loss}")

    model_flops = 3 * batch * k * resnet_forward_flops(cfg.arch, (crop, crop))
    med = statistics.median(win_times)
    emit({
        "metric": "tsn_finetune_step_throughput",
        "value": round(batch / med, 2),
        "unit": "clips/sec/gpu",
        "vs_baseline": None,
        "detail": {
            "device": dev.type,
            "gpu": card(dev),
            "arch": cfg.arch,
            "compute_dtype": cfg.compute_dtype,
            "batch_clips": batch,
            "num_segments": k,
            "frame_hw": list(hw),
            "crop": crop,
            "median_step_s": round(med, 6),
            "step_tflops_model": round(model_flops / 1e12, 3),
            "model_tflops_per_s": round(model_flops / med / 1e12, 2),
            **mfu_fields(model_flops / med, dev),
            "flops_source": "analytic_3x_forward",
            "window": window,
            "iters": iters,
            "clips_per_sec_min": round(batch / max(win_times), 2),
            "clips_per_sec_max": round(batch / min(win_times), 2),
            "final_loss": loss,
            "build_s": build_s,
        },
    })


if __name__ == "__main__":
    main()
