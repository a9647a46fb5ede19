"""Classify bench: per-query latency at batch 1 and batched queries/s.

Counterpart of the reference's ``bench_classify.py``, measured as the
port's ``cmd_classify`` runs a query: read the query clip's frames, TSN
center sampling, the feature program (``make_feature_fn`` at the
``episode_cpu`` preset's extract config: kernel 1 crops 256x340 -> 224,
the folded ResNet with kernel 2; kernel 7 under ``EOV_CLASSIFY_QUANT=int8``)
and the matcher against a [C, M, D] support table (``cli._class_scores``:
kernel 3 on the card), then the argmax on the host. Support features are
random-normal (numpy seed 7); their values do not change the work.

ONE JSON line, metric ``classify_query_latency``: ``value`` the median
batch-1 latency in ms; ``detail.queries_per_s_batched`` the steady-state
rate over every query in batches of ``EOV_CLASSIFY_BATCH`` (a short tail
batch is filled by repeating queries, as the reference does);
``detail.match_ms_median`` the matcher's share (timed after the features
are on the device). Host clock around each call, after a warm-up of both
batch shapes.

Knobs (the reference's names and defaults): ``EOV_CLASSIFY_REPEATS`` (5),
``EOV_CLASSIFY_ARCH`` (resnet50), ``EOV_CLASSIFY_FRAMES`` (32),
``EOV_CLASSIFY_HW`` (256x340), ``EOV_CLASSIFY_CLASSES`` (101),
``EOV_CLASSIFY_SHOTS`` (5), ``EOV_CLASSIFY_QUERIES`` (16),
``EOV_CLASSIFY_BATCH`` (8), ``EOV_CLASSIFY_QUANT`` (0 | off | int8).

Two deliberate differences from the reference:

* ``EOV_CLASSIFY_DEVICE`` (default ``cuda``) where the reference has
  ``EOV_CLASSIFY_PLATFORM`` (default cpu); ``cpu`` gives its config, and
  ``cuda`` without a GPU raises.
* ``EOV_CLASSIFY_FRAMES_FROM`` = ``jpeg`` (default: JPEG frame folders
  read through PIL, the reference's fixture) | ``eovc_raw`` (the same
  clips packed into a RAW EOVC shard and read by the port's EOVC reader,
  for a machine without PIL). The line names the source.
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
                                        emit, frame_source, reader_name, sync)

__all__ = ["main"]


def main() -> None:
    from eov_tpu_torch.cli import _class_scores
    from eov_tpu_torch.config import get_preset
    from eov_tpu_torch.data.datasets import SyntheticVideoDataset
    from eov_tpu_torch.data.segments import center_indices_np
    from eov_tpu_torch.extract import make_feature_fn
    from eov_tpu_torch.models.resnet import random_state_dict
    from eov_tpu_torch.utils.device import resolve_device

    dev = resolve_device(os.environ.get("EOV_CLASSIFY_DEVICE", "cuda"))
    source = frame_source("EOV_CLASSIFY_FRAMES_FROM")
    repeats = int(os.environ.get("EOV_CLASSIFY_REPEATS", "5"))
    preset = get_preset("episode_cpu")
    ecfg = preset.extract
    arch = os.environ.get("EOV_CLASSIFY_ARCH", ecfg.arch)
    quant_env = os.environ.get("EOV_CLASSIFY_QUANT", "0")
    if quant_env not in ("", "0", "off", "int8"):
        raise SystemExit(
            f"EOV_CLASSIFY_QUANT={quant_env!r}: accepted forms are 0/off "
            "(the bf16/f32 path) and int8")
    quant = "int8" if quant_env == "int8" else None
    ecfg = dataclasses.replace(ecfg, arch=arch, quant=quant)
    n_frames = int(os.environ.get("EOV_CLASSIFY_FRAMES", "32"))
    fh, _, fw = os.environ.get("EOV_CLASSIFY_HW", "256x340").partition("x")
    fh, fw = int(fh), int(fw)
    n_classes = int(os.environ.get("EOV_CLASSIFY_CLASSES", "101"))
    n_shots = int(os.environ.get("EOV_CLASSIFY_SHOTS", "5"))
    n_queries = int(os.environ.get("EOV_CLASSIFY_QUERIES", "16"))
    batch = int(os.environ.get("EOV_CLASSIFY_BATCH", "8"))
    metric, fusion = preset.eval.metric, preset.eval.fusion

    build_s = build_kernels(dev)
    fn = make_feature_fn(random_state_dict(ecfg.arch, seed=0), ecfg, dev)
    with tempfile.TemporaryDirectory(prefix="eov_classify_") as root:
        n_cls = max(2, min(5, n_queries))
        syn = SyntheticVideoDataset(
            n_classes=n_cls, clips_per_class=-(-n_queries // n_cls),
            min_frames=n_frames, max_frames=n_frames, height=fh, width=fw,
            seed=0)
        ds = clip_dataset(root, syn, source)
        records = ds.records[:n_queries]

        def decode(rec):
            return ds.get_frames(rec, center_indices_np(rec.num_frames,
                                                        ecfg.num_segments))

        d = int(fn(torch.from_numpy(decode(records[0])[None])).shape[-1])
        rng = np.random.default_rng(7)
        table = torch.from_numpy(rng.normal(size=(n_classes, n_shots, d))
                                 .astype(np.float32)).to(dev)
        mask = torch.ones(n_classes, n_shots, device=dev)

        def classify_batch(recs):
            """cmd_classify's path for a batch -> (preds, matcher s)."""
            q = fn(torch.from_numpy(np.stack([decode(r) for r in recs])))
            sync(dev)
            t0 = time.perf_counter()
            scores = _class_scores(q, table, mask, metric=metric,
                                   fusion=fusion)
            preds = scores.argmax(dim=-1).cpu().numpy()
            return preds, time.perf_counter() - t0

        t0 = time.perf_counter()
        classify_batch(records[:1])
        classify_batch((records * batch)[:batch])
        warm_s = time.perf_counter() - t0

        lat, match_ms = [], []
        for i in range(repeats):
            t0 = time.perf_counter()
            _, m = classify_batch([records[i % len(records)]])
            lat.append(time.perf_counter() - t0)
            match_ms.append(m * 1e3)

        t0 = time.perf_counter()
        done = 0
        for s in range(0, len(records), batch):
            recs = records[s:s + batch]
            if len(recs) < batch:  # keep the batch shape
                recs = (recs * batch)[:batch]
            classify_batch(recs)
            done += batch
        batched_s = time.perf_counter() - t0

    med = statistics.median(lat)
    emit({
        "metric": "classify_query_latency",
        "value": round(med * 1e3, 3),
        "unit": "ms/query",
        "vs_baseline": None,
        "detail": {
            "platform": dev.type,
            "gpu": card(dev),
            "frames_from": source,
            "reader": reader_name(ds),
            "arch": ecfg.arch,
            "compute_dtype": ecfg.compute_dtype,
            "repeats": repeats,
            "ms_min": round(min(lat) * 1e3, 3),
            "ms_max": round(max(lat) * 1e3, 3),
            "match_ms_median": round(statistics.median(match_ms), 4),
            "queries_per_s_batched": round(done / batched_s, 2),
            "batch": batch,
            "n_queries": len(records),
            "support_classes": n_classes,
            "support_shots": n_shots,
            "feature_dim": d,
            "frames_per_query": ecfg.num_segments,
            "frame_hw": [fh, fw],
            "warmup_s": round(warm_s, 3),
            "quant": quant,
            "build_s": build_s,
            "params": "random_state_dict(seed=0) (the latency does not "
                      "depend on the weights' values)",
        },
    })


if __name__ == "__main__":
    main()
