"""Episode bench: the latency of one cold 5-way 1-shot episode (config 1).

Counterpart of the reference's ``bench_episode.py``: one user asks one
question of clips that were never extracted, so the latency covers
everything after the warm-up: reading the frames, TSN center sampling,
crop and normalize, 10 clip forwards at batch 1 (5 support + 5 query, at
the ``episode_cpu`` preset's extract config: f32, kernel 1 and the folded
ResNet with kernel 2 on the card) and the cosine match, as the port's
``cmd_episode`` runs them (``episode_class_scores``: kernel 3 on the
card); the predictions reach the host, which ends the episode. Each
repeat draws fresh support and query picks (numpy seed = repeat). Host
clock; the median repeat.

ONE JSON line, metric ``oneshot_episode_latency``, ms/episode.

Knobs (the reference's names and defaults): ``EOV_EPISODE_REPEATS`` (5),
``EOV_EPISODE_ARCH`` (resnet50), ``EOV_EPISODE_FRAMES`` (32),
``EOV_EPISODE_HW`` (256x340). Two deliberate differences from the
reference, as in the classify bench: ``EOV_EPISODE_DEVICE`` (default
``cuda``; ``cpu`` is config 1 as the reference runs it; ``cuda`` without
a GPU raises) where the reference has ``EOV_EPISODE_PLATFORM`` (default
cpu), and ``EOV_EPISODE_FRAMES_FROM`` = ``jpeg`` (default) | ``eovc_raw``
(see ``bench/common.py:clip_dataset``).
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from eov_tpu_torch.bench.common import (build_kernels, card, clip_dataset,
                                        emit, frame_source, reader_name)

__all__ = ["main"]


def main() -> None:
    from eov_tpu_torch.config import get_preset
    from eov_tpu_torch.data.datasets import SyntheticVideoDataset
    from eov_tpu_torch.data.segments import center_indices_np
    from eov_tpu_torch.extract import make_feature_fn
    from eov_tpu_torch.models.resnet import random_state_dict
    from eov_tpu_torch.ops.similarity import episode_class_scores
    from eov_tpu_torch.utils.device import resolve_device

    dev = resolve_device(os.environ.get("EOV_EPISODE_DEVICE", "cuda"))
    source = frame_source("EOV_EPISODE_FRAMES_FROM")
    repeats = int(os.environ.get("EOV_EPISODE_REPEATS", "5"))
    preset = get_preset("episode_cpu")
    ecfg = dataclasses.replace(
        preset.extract, arch=os.environ.get("EOV_EPISODE_ARCH",
                                            preset.extract.arch))
    n_frames = int(os.environ.get("EOV_EPISODE_FRAMES", "32"))
    fh, _, fw = os.environ.get("EOV_EPISODE_HW", "256x340").partition("x")
    fh, fw = int(fh), int(fw)
    n_way = preset.eval.n_way

    build_s = build_kernels(dev)
    fn = make_feature_fn(random_state_dict(ecfg.arch, seed=0), ecfg, dev)
    with tempfile.TemporaryDirectory(prefix="eov_episode_") as root:
        syn = SyntheticVideoDataset(
            n_classes=n_way, clips_per_class=2, min_frames=n_frames,
            max_frames=n_frames, height=fh, width=fw, seed=0)
        ds = clip_dataset(root, syn, source)
        by_class: dict[int, list] = {}
        for r in ds.records:
            by_class.setdefault(r.label, []).append(r)

        def feat(rec):
            idx = center_indices_np(rec.num_frames, ecfg.num_segments)
            return fn(torch.from_numpy(ds.get_frames(rec, idx)[None]))[0]

        def episode(seed: int) -> float:
            rng = np.random.default_rng(seed)
            sup, qry = [], []
            for c in sorted(by_class):
                picks = rng.choice(len(by_class[c]), size=2, replace=False)
                sup.append(feat(by_class[c][picks[0]]))
                qry.append(feat(by_class[c][picks[1]]))
            support = torch.stack(sup)[None, :, None]  # [1, N, 1, D]
            mask = torch.ones(support.shape[:3], device=support.device)
            scores = episode_class_scores(torch.stack(qry)[None], support,
                                          mask)
            preds = scores.argmax(dim=-1)[0].cpu().numpy()
            return float((preds == np.arange(n_way)).mean())

        t0 = time.perf_counter()
        episode(0)  # warm-up: first touch of every kernel and buffer
        warm_s = time.perf_counter() - t0
        times, accs = [], []
        for i in range(repeats):
            t0 = time.perf_counter()
            accs.append(episode(i + 1))
            times.append(time.perf_counter() - t0)

    med = statistics.median(times)
    emit({
        "metric": "oneshot_episode_latency",
        "value": round(med * 1e3, 3),
        "unit": "ms/episode",
        "vs_baseline": None,
        "detail": {
            "platform": dev.type,
            "gpu": card(dev),
            "frames_from": source,
            "reader": reader_name(ds),
            "arch": ecfg.arch,
            "compute_dtype": ecfg.compute_dtype,
            "preset": "episode_cpu",
            "repeats": repeats,
            "ms_min": round(min(times) * 1e3, 3),
            "ms_max": round(max(times) * 1e3, 3),
            "warmup_s": round(warm_s, 3),
            "clips_per_episode": 2 * n_way,
            "frames_decoded": 2 * n_way * ecfg.num_segments,
            "frame_hw": [fh, fw],
            "accuracy_mean": float(np.mean(accs)),
            "build_s": build_s,
            "params": "random_state_dict(seed=0) (the latency does not "
                      "depend on the weights' values)",
        },
    })


if __name__ == "__main__":
    main()
