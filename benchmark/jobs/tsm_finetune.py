"""TSM + non-local finetune from RAW EOVC shards: the ``finetune`` job
(``train.train_epoch`` driving ``train.make_train_step``, epoch after epoch
with the state carried, the same window and the same check), on the
``tsm_nl_resnet50`` arch with every BN trained.

What differs from ``finetune``: the weights are ``reference/tsm_nl.py``'s
(ResNet-50's at the seed, then the non-local leaves), and the reference
steps and trained leaves are ``reference/tsm_train.py``'s. Set-up asks the
program for the arch before it writes the shard set, so a program without
it fails at once.
"""

from __future__ import annotations

import time

import torch

from benchmark import data
from benchmark.jobs import finetune as FT
from benchmark.reference import tsm_nl, tsm_train
from benchmark.reference.shards import ShardSet


class Job(FT.Job):
    def setup(self) -> dict:
        from eov_tpu_torch import train as T
        from eov_tpu_torch.data.datasets import EovcVideoDataset
        from eov_tpu_torch.models import get_arch

        get_arch(self.cfg["arch"])  # a program without it stops here
        run, dev = self.run, self.run.device
        parts = {}
        t = time.perf_counter()
        self.root = data.shard_set(run.cache, self.traffic["data"])
        self.ds = FT.TimedReader(EovcVideoDataset(self.root), run.spans)
        parts["shards_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.tcfg = FT.train_config(self.cfg, self.traffic, run.seed,
                                    run.world)
        weights = tsm_nl.make_weights(self.cfg, run.seed, dev)
        parts["weights_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.state = T.create_train_state(self.tcfg, dev, weights=weights)
        del weights
        parts["state_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.mesh = None
        self.step = T.make_train_step(self.tcfg, dev)
        parts["step_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.images = (self.traffic["batch_clips_per_chip"]
                       * self.cfg["train_segments"])
        self.state, _ = T.train_epoch(
            self.state, self._recorder("setup", FT._to_cpu), self.tcfg,
            self.ds, epoch=0)
        self._sync()
        self.start = self._snapshot()
        parts["warmup_epoch_s"] = time.perf_counter() - t
        self.epoch = 1
        return parts

    def program_side(self, start: dict, phase: str) -> dict:
        """As ``finetune``'s, over ``tsm_train``'s trained leaves."""
        rec, wd = self.record[phase], self.cfg["weight_decay"]
        buf0 = self.start["buf"] if phase == "window" else {}
        mom = self.cfg["momentum"]
        leaves, decay = tsm_train.trained(self.cfg, start)
        dev = self.run.device
        grad = {}
        for n in leaves:
            buf = rec["buf"].get(n)
            if buf is None:
                grad[n] = torch.zeros_like(start[n])
                continue
            g = buf.to(dev) - (wd * start[n] if n in decay else 0)
            if n in buf0:
                g = g - mom * buf0[n].to(dev)
            grad[n] = g
        delta = {n: rec["p3"][n].to(dev) - start[n] for n in leaves}
        return {"loss": [float(v) for v in rec["loss"]], "grad": grad,
                "delta": delta}

    def reference(self, phase: str, **kw) -> tuple[dict, dict]:
        """(the weights the phase starts from, the reference's first three
        steps from them); ``kw`` as ``tsm_train.first_steps`` takes them
        (the control's or a fault's)."""
        dev = self.run.device
        p0 = tsm_nl.make_weights(self.cfg, self.run.seed, dev)
        train = {"batch_clips": self.traffic["batch_clips_per_chip"]}
        if phase == "window":
            s = self.start
            p0 = {n: s["weights"][n].to(dev) for n in p0}
            kw = {"epoch": 1, "step0": s["step"], "buf0": s["buf"], **kw}
        return p0, tsm_train.first_steps(
            p0, self.cfg, train, ShardSet(self.root), self.run.seed, dev,
            n_steps=3, **kw)
