"""Eval bench: episodic one-shot eval throughput (episodes/s).

Counterpart of the reference's ``bench_eval.py``: 64 episodes a step
(sample + gather + the matcher + argmax + accuracy) through the port's
``eval_step`` over a cached-feature table of Kinetics-100 meta-test size,
24 classes x 100 clips x 2048-d float32, made from numpy seed 0 as the
reference makes it. Step i of a window scores the episodes with ordinals
``[i * 64, (i + 1) * 64)``, the canonical protocol ``evaluate`` drives.
Prints ONE JSON line: ``metric`` ``oneshot_eval_throughput``, ``value`` in
episodes/s, and ``full_600_episode_eval_s``, the protocol's 600 episodes
at that rate.

Timing: one warm-up window, untimed; then ``iters`` windows of ``window``
steps, each between two CUDA events and one synchronize; the value is the
median window's rate.

Knobs (the reference's names; defaults on ``cuda`` | elsewhere):
``EOV_BENCH_DEVICE`` (cuda | cpu), ``EOV_EVAL_MATCHER`` (auto = kernel 3
on the card | xla = the plain version | pallas = kernel 3, refused on the
CPU), ``EOV_EVAL_EPISODES_PER_STEP`` (64), ``EOV_EVAL_ITERS`` (10 | 3),
``EOV_EVAL_WINDOW`` (512 | 2).
"""

from __future__ import annotations

import os
import statistics

import numpy as np
import torch

from eov_tpu_torch.bench.common import (bench_device, card, build_kernels,
                                        emit, env_default, step_seconds)

__all__ = ["main"]


def main() -> None:
    from eov_tpu_torch import prng
    from eov_tpu_torch.eval import eval_step

    dev = bench_device()
    matcher = os.environ.get("EOV_EVAL_MATCHER", "auto")
    e_step = int(os.environ.get("EOV_EVAL_EPISODES_PER_STEP", "64"))
    iters = int(env_default("EOV_EVAL_ITERS", "10", "3", dev))
    window = int(env_default("EOV_EVAL_WINDOW", "512", "2", dev))

    rng = np.random.default_rng(0)
    c, m, d = 24, 100, 2048
    feats = (rng.normal(size=(c, 1, d))
             + 0.8 * rng.normal(size=(c, m, d))).astype(np.float32)
    features = torch.from_numpy(feats).to(dev)
    counts = torch.full((c,), m, dtype=torch.int64, device=dev)
    key = prng.key(0, device=dev)
    ordinal = 0
    accs = []

    def one_step():
        nonlocal ordinal
        accs.append(eval_step(
            key, ordinal, features, counts, None, None, n_way=5, k_shot=1,
            n_query=1, n_step=e_step, metric="cosine", fusion="max",
            matcher=matcher))
        ordinal += e_step

    build_s = build_kernels(dev) if matcher != "xla" else None
    try:
        step_seconds(one_step, window, dev)  # warm-up window, untimed
    except ValueError as e:  # e.g. matcher='pallas' on the CPU
        raise SystemExit(f"eval bench: {e}") from None
    win_times = [step_seconds(one_step, window, dev) for _ in range(iters)]
    mean_acc = float(torch.cat(accs).mean())
    if not 0.0 <= mean_acc <= 1.0:
        raise SystemExit(f"eval bench: mean accuracy {mean_acc}")

    med = statistics.median(win_times)
    rate = e_step / med
    emit({
        "metric": "oneshot_eval_throughput",
        "value": round(rate, 2),
        "unit": "episodes/sec/gpu",
        "vs_baseline": None,
        "detail": {
            "device": dev.type,
            "gpu": card(dev),
            "matcher": matcher,
            "episodes_per_step": e_step,
            "table_cmd": [c, m, d],
            "median_step_s": round(med, 7),
            "full_600_episode_eval_s": round(600 / rate, 5),
            "window": window,
            "iters": iters,
            "eps_per_sec_min": round(e_step / max(win_times), 2),
            "eps_per_sec_max": round(e_step / min(win_times), 2),
            "mean_accuracy": mean_acc,
            "build_s": build_s,
        },
    })


if __name__ == "__main__":
    main()
