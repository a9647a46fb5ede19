"""Feature extraction from RAW EOVC shards: ``extract.extract_features``
with the feature program of ``extract.make_feature_fn``, pass after pass
over the shard set, each pass into a fresh ``FeatureStore``.

Set-up writes (or finds) the shard set, opens it with the program's
``EovcVideoDataset``, makes the weights on the device from the seed, builds
the feature program once (as a deployment extracting a large dataset does)
and runs one pass to warm up every shape. The window runs whole passes
until ``--seconds`` have passed, deleting each pass's store before the
next; ``extract_clips_per_s`` is the clips stored over that time. ``check``
reads every clip of the last pass's store and holds it against the
reference's features of the same clip.

Spans: ``read`` around each ``get_batch`` (the reader, on the loop's decode
thread), ``features[n]`` around each call of the feature program (n images),
``rmtree[0]`` around the deletion of the previous pass's store.
"""

from __future__ import annotations

import gc
import os
import shutil
import time

import numpy as np
import torch

from benchmark import data, tracing
from benchmark.jobs.finetune import TimedReader
from benchmark.reference import extract as ref_extract
from benchmark.reference import resnet as ref_resnet
from benchmark.reference.shards import ShardSet


def extract_config(cfg: dict, traffic: dict):
    import dataclasses

    from eov_tpu_torch.config import get_preset

    base = get_preset(traffic["preset"]).extract
    return dataclasses.replace(
        base, arch=cfg["arch"], num_segments=cfg["extract_segments"],
        batch_clips=traffic["batch_clips"], scale_size=cfg["scale_size"],
        crop_size=cfg["crop_size"], compute_dtype=cfg["compute_dtype"],
        quant=traffic.get("quant"))


def feature_gaps(store: dict, ref: torch.Tensor, vids: list,
                 labels: list) -> dict:
    """The worst clip's ‖a − b‖ / ‖b‖ of the stored features against the
    reference's, and the clips the store lacks or labels wrongly."""
    missing = [i for i, v in enumerate(vids)
               if v not in store or store[v][1] != labels[i]]
    lost = set(missing)
    have = [i for i in range(len(vids)) if i not in lost]
    worst = 0.0
    if have:
        a = torch.from_numpy(np.stack([store[vids[i]][0] for i in have])).to(
            ref.device, torch.float32)
        b = ref[have]
        worst = float(((a - b).norm(dim=1) / b.norm(dim=1)).max())
    return {"feature_gap": worst, "missing_clips": float(len(missing))}


class Job:
    scope = "features"

    def __init__(self, run):
        self.run = run
        self.cfg, self.traffic = run.cell.config, run.cell.traffic
        self.work = os.path.join(run.cache, "work", run.cell.name)

    def setup(self) -> dict:
        from eov_tpu_torch.data.datasets import EovcVideoDataset
        from eov_tpu_torch.extract import make_feature_fn

        run, dev = self.run, self.run.device
        parts = {}
        t = time.perf_counter()
        self.root = data.shard_set(run.cache, self.traffic["data"])
        self.ds = TimedReader(EovcVideoDataset(self.root), run.spans)
        parts["shards_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.ecfg = extract_config(self.cfg, self.traffic)
        weights = ref_resnet.make_weights(self.cfg, run.seed, dev)
        parts["weights_s"] = time.perf_counter() - t
        t = time.perf_counter()
        program = make_feature_fn(weights, self.ecfg, dev)
        del weights
        k = self.ecfg.num_segments

        def feature_fn(frames):
            with run.spans.span(f"features[{frames.shape[0] * k}]"):
                return program(frames)

        self.feature_fn = feature_fn
        parts["program_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self._pass()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        parts["warmup_pass_s"] = time.perf_counter() - t
        return parts

    def _pass(self) -> dict:
        from eov_tpu_torch.data.store import FeatureStore
        from eov_tpu_torch.extract import extract_features

        with self.run.spans.span("rmtree[0]"):
            shutil.rmtree(self.work, ignore_errors=True)
        store = FeatureStore(self.work, class_names=self.ds.class_names,
                             quant=self.ecfg.quant)
        return extract_features(self.ds, None, store, self.ecfg,
                                feature_fn=self.feature_fn,
                                device=self.run.device)

    def window(self, seconds: float, prof) -> dict:
        run, k = self.run, self.ecfg.num_segments
        clips = failed = attempted = 0
        win = tracing.Window(run, prof, self.traffic["trace_seconds"])
        while True:
            stats = self._pass()
            clips += stats["extracted"]
            failed += stats["failed"]
            attempted += stats["total"]
            if win.lap(clips * k) >= seconds:
                break
        win.close(clips * k)
        run.counts.update(attempted=attempted, failed=failed)
        return {"extract_clips_per_s": clips / run.window_s}

    def main_tid(self, trace):
        s = trace.scopes(self.scope)
        return s[0]["tid"] if s else None

    def release(self) -> None:
        del self.feature_fn, self.ds
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def stored(self) -> dict:
        from eov_tpu_torch.data.store import FeatureStore

        return FeatureStore(self.work).load_all()

    def reference(self, shards: ShardSet) -> torch.Tensor:
        """The reference's features of every clip of the shard set."""
        p = ref_resnet.make_weights(self.cfg, self.run.seed, self.run.device)
        return ref_extract.features(
            p, self.cfg, shards, list(range(len(shards.records))),
            self.run.device, k=self.cfg["extract_segments"])

    def check(self) -> dict:
        shards = ShardSet(self.root)
        ref = self.reference(shards)
        got = feature_gaps(self.stored(), ref,
                           [shards.video_id(i) for i in range(len(ref))],
                           [shards.label(i) for i in range(len(ref))])
        limits = self.run.cell.limits
        return {k: (v, limits[k]) for k, v in got.items()}
