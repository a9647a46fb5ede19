"""End-to-end bench: sustained extraction throughput, host work included.

Counterpart of the reference's ``bench_e2e.py``: synthetic clips packed by
``tools/pack_eovc.pack`` into one RAW EOVC shard at the storage size
``EOV_E2E_HW`` (224: the production crop-size storage, normalize only),
under ``/dev/shm`` where it exists, then ``extract_features`` over its
records (``records=``, ``pad_batches``): the EOVC reader (the native
loader where it builds, else the python reader; ``detail.reader`` says
which), the buffer ring, the copy to the card, the feature program, the
copy back and the store. One host clock around the whole call, after a
warm-up on 3 batches into a throwaway store. Prints ONE JSON line:
``metric`` ``e2e_sustained_extraction_throughput``, ``value`` in clips/s.

Context in ``detail``: the decode-only rate over the same shard (batches
of ``get_batch`` into one reused buffer); the feature program's time per
batch (CUDA events, median of 5, frames on the card) and from it the
device busy time (that x the batch count) and the device idle share of the
wall (``null`` off the card). Set-up (packing) is timed apart.

Knobs: ``EOV_BENCH_DEVICE`` (cuda | cpu), ``EOV_E2E_CLIPS`` (512 | 8),
``EOV_E2E_BATCH`` (64 | 4), ``EOV_E2E_HW`` (224), ``EOV_E2E_DIR``.
"""

from __future__ import annotations

import os
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

from eov_tpu_torch.bench.common import (bench_device, build_kernels, card,
                                        emit, env_default, step_seconds, sync)

__all__ = ["main"]


def main() -> None:
    from eov_tpu_torch.data.datasets import (EovcVideoDataset,
                                             SyntheticVideoDataset)
    from eov_tpu_torch.data.segments import center_indices_np
    from eov_tpu_torch.data.store import FeatureStore
    from eov_tpu_torch.extract import (ExtractConfig, extract_features,
                                       make_feature_fn)
    from eov_tpu_torch.models.resnet import random_state_dict
    from eov_tpu_torch.tools.pack_eovc import pack

    dev = bench_device()
    n_clips = int(env_default("EOV_E2E_CLIPS", "512", "8", dev))
    batch = int(env_default("EOV_E2E_BATCH", "64", "4", dev))
    side = int(os.environ.get("EOV_E2E_HW", "224"))
    k = 8
    base = os.environ.get(
        "EOV_E2E_DIR", "/dev/shm" if os.path.isdir("/dev/shm") else None)
    build_s = build_kernels(dev)
    workdir = tempfile.mkdtemp(prefix="eov_e2e_", dir=base)
    try:
        t0 = time.perf_counter()
        src = SyntheticVideoDataset(
            n_classes=8, clips_per_class=-(-n_clips // 8), seed=0,
            height=side, width=side, min_frames=12, max_frames=16)
        path = os.path.join(workdir, "bench.raw.eovc")
        pack(src, path, storage_short_side=side, codec="raw")
        pack_s = time.perf_counter() - t0
        ds = EovcVideoDataset(path)
        recs = list(ds.records)[:n_clips]

        cfg = ExtractConfig(num_segments=k, batch_clips=batch,
                            scale_size=side, crop_size=224, pad_batches=True)
        weights = random_state_dict(cfg.arch, seed=0)
        feature_fn = make_feature_fn(weights, cfg, dev)
        # Warm-up: the program, the host buffer ring and its first-touch
        # page faults, as a production job's first seconds pay them.
        extract_features(ds, weights,
                         FeatureStore(os.path.join(workdir, "warm"),
                                      class_names=ds.class_names),
                         cfg, feature_fn=feature_fn, device=dev,
                         records=recs[:3 * batch])

        store = FeatureStore(os.path.join(workdir, "store"),
                             class_names=ds.class_names)
        sync(dev)
        t0 = time.perf_counter()
        stats = extract_features(ds, weights, store, cfg,
                                 feature_fn=feature_fn, device=dev,
                                 records=recs)
        sync(dev)
        wall = time.perf_counter() - t0
        if stats["extracted"] != len(recs) or stats["failed"]:
            raise SystemExit(f"e2e bench: extraction incomplete: {stats}")
        stored = store.load_all()
        if len(stored) != len(recs) or not all(
                np.isfinite(f).all() for f, _ in stored.values()):
            raise SystemExit("e2e bench: the store does not hold one finite "
                             "feature per record")

        # Decode only: batch-sized chunks into one reused buffer, as the
        # extraction loop drives the reader.
        dec_batch = min(batch, len(recs))
        n_dec = len(recs) // dec_batch * dec_batch
        dec_buf = None
        t0 = time.perf_counter()
        for s in range(0, n_dec, dec_batch):
            chunk = recs[s:s + dec_batch]
            idx = np.stack([center_indices_np(r.num_frames, k)
                            for r in chunk])
            dec_buf = ds.get_batch(chunk, idx, out=dec_buf)
        decode_s = time.perf_counter() - t0

        # The feature program alone on one full batch already on the card.
        idx = np.stack([center_indices_np(r.num_frames, k)
                        for r in recs[:dec_batch]])
        frames = torch.from_numpy(ds.get_batch(recs[:dec_batch], idx)).to(dev)
        if dec_batch < batch:
            frames = torch.cat([frames, frames[-1:].expand(
                batch - dec_batch, *frames.shape[1:])])
        program_s = statistics.median(
            step_seconds(lambda: feature_fn(frames), 1, dev)
            for _ in range(5))
        reader = "native" if ds.is_native else "python"
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    n_batches = -(-len(recs) // batch)
    busy = program_s * n_batches
    sustained = len(recs) / wall
    on_card = dev.type == "cuda"
    emit({
        "metric": "e2e_sustained_extraction_throughput",
        "value": round(sustained, 2),
        "unit": "clips/sec",
        "vs_baseline": round(sustained / 1000.0, 4),
        "detail": {
            "device": dev.type,
            "gpu": card(dev),
            "clips": len(recs),
            "extracted": stats["extracted"],
            "batch_clips": batch,
            "num_segments": k,
            "frame_hw": [side, side],
            "wall_s": round(wall, 4),
            "host_decode_only_clips_per_s": round(n_dec / decode_s, 1),
            "reader": reader,
            "feature_program_s_per_batch": round(program_s, 6),
            "device_busy_est_s": round(busy, 4) if on_card else None,
            "device_idle_share_est": (round(1.0 - busy / wall, 4)
                                      if on_card else None),
            "pack_s": round(pack_s, 3),
            "build_s": build_s,
            "includes": "decode + H2D + device program + D2H + store",
        },
    })


if __name__ == "__main__":
    main()
