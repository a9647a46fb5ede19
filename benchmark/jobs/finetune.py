"""TSN finetune from RAW EOVC shards: ``train.train_epoch`` driving
``train.make_train_step`` (the mesh form on several chips), epoch after
epoch with the state carried.

Set-up writes (or finds) the shard set, opens it with the program's
``EovcVideoDataset``, makes the weights on the device from the seed, builds
the state and the step, and runs epoch 0 through them: that warms up every
shape the window runs. It then keeps the state that the window starts from
(weights, buffers, SGD's momentum, the step count). The window runs whole
epochs until ``--seconds`` have passed; ``train_clips_per_s`` is the clips
trained by all ranks over that time.

``check`` holds two runs of three steps against the reference: the first
three of epoch 0, from the seed's weights (``loss_gap``, ``grad_gap``,
``update_gap``), and the first three of the window's first epoch, from the
state the window started from (``window_loss_gap``, ``window_grad_gap``,
``window_update_gap``): its order, keys, learning rate and momentum carried
across the epoch boundary and, on several chips, the state synchronised
at the epoch's start. Each reads each step's loss, the first gradient as
SGD's momentum holds it after one step, and each trained leaf's change
after three.

Spans: ``read`` around each ``get_frames`` (the reader), ``step[n]`` around
each step (n images on this rank).
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from benchmark import data, tracing
from benchmark.reference import resnet as ref_resnet
from benchmark.reference import train as ref_train
from benchmark.reference.shards import ShardSet


class TimedReader:
    """The dataset with a ``read`` span around each read."""

    def __init__(self, ds, spans):
        self._ds, self._spans = ds, spans
        self.records, self.class_names = ds.records, ds.class_names

    def get_frames(self, record, indices):
        with self._spans.span("read"):
            return self._ds.get_frames(record, indices)

    def get_batch(self, records, indices, out=None):
        with self._spans.span("read"):
            return self._ds.get_batch(records, indices, out=out)


def train_config(cfg: dict, traffic: dict, seed: int, world: int):
    from eov_tpu_torch.train import TrainConfig

    return TrainConfig(
        num_classes=cfg["num_classes"], arch=cfg["arch"],
        num_segments=cfg["train_segments"],
        batch_clips=traffic["batch_clips_per_chip"] * world,
        lr=cfg["lr"], momentum=cfg["momentum"],
        weight_decay=cfg["weight_decay"],
        lr_decay_steps=cfg["lr_decay_steps"],
        lr_decay_rate=cfg["lr_decay_rate"], partial_bn=cfg["partial_bn"],
        dropout=cfg["dropout"], augment=traffic["augment"],
        compute_dtype=cfg["compute_dtype"], scale_size=cfg["scale_size"],
        crop_size=cfg["crop_size"], seed=seed)


def quiet_leaves(ref: dict) -> list[str]:
    """Leaves whose reference gradient is under a thousandth of the median
    leaf's: they move by round-off alone and are not compared."""
    gn = {n: float(g.norm()) for n, g in ref["grad"].items()}
    med = statistics.median(gn.values())
    return [n for n in gn if gn[n] < 1e-3 * med]


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers compared: the worst step's relative loss gap; by the
    worst trained leaf, the gap between the program's and the reference's
    norms of the first gradient and of the change after the last step,
    over the larger of the reference leaf's norm and the median leaf's.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone and are left out of both."""
    out = {"loss_gap": max(abs(a - b) / abs(b)
                           for a, b in zip(prog["loss"], ref["loss"]))}
    gn = {n: float(g.norm()) for n, g in ref["grad"].items()}
    med_g = statistics.median(gn.values())
    quiet = set(quiet_leaves(ref))
    keep = [n for n in gn if n not in quiet]
    dn = {n: float(ref["delta"][n].norm()) for n in keep}
    med_d = statistics.median(dn.values())

    def worst(key, norms, med):
        return max(abs(float(prog[key][n].norm()) - norms[n])
                   / max(norms[n], med) for n in keep)

    out["grad_gap"] = worst("grad", gn, med_g)
    out["update_gap"] = worst("delta", dn, med_d)
    return out


PHASES = (("setup", ""), ("window", "window_"))  # phase, prefix of its gaps


class Job:
    scope = "step"

    def __init__(self, run):
        self.run = run
        self.cfg, self.traffic = run.cell.config, run.cell.traffic
        self.record: dict = {"setup": {}, "window": {}}

    # -- set-up -----------------------------------------------------------
    def setup(self) -> dict:
        from eov_tpu_torch import train as T
        from eov_tpu_torch.data.datasets import EovcVideoDataset

        run, dev = self.run, self.run.device
        parts = {}
        t = time.perf_counter()
        self.root = data.shard_set(run.cache, self.traffic["data"])
        self.ds = TimedReader(EovcVideoDataset(self.root), run.spans)
        parts["shards_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.tcfg = train_config(self.cfg, self.traffic, run.seed, run.world)
        weights = ref_resnet.make_weights(self.cfg, run.seed, dev)
        parts["weights_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.state = T.create_train_state(self.tcfg, dev, weights=weights)
        del weights
        parts["state_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.mesh = None
        if run.world > 1:
            from eov_tpu_torch.parallel.mesh import make_mesh

            self.mesh = make_mesh(run.world, 1)
        self.step = T.make_train_step(self.tcfg, dev, mesh=self.mesh)
        parts["step_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.images = (self.traffic["batch_clips_per_chip"]
                       * self.cfg["train_segments"])
        self.state, _ = T.train_epoch(
            self.state, self._recorder("setup", _to_cpu), self.tcfg, self.ds,
            epoch=0, mesh=self.mesh)
        self._sync()
        self.start = self._snapshot()
        parts["warmup_epoch_s"] = time.perf_counter() - t
        self.epoch = 1
        return parts

    def _sync(self):
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)

    def _snapshot(self) -> dict:
        """The state the window starts from, on the host."""
        st = self.state
        named = dict(st.model.named_parameters())
        opt = st.optimizer
        return {"step": st.step,
                "weights": {n: _to_cpu(t)
                            for n, t in st.model.state_dict().items()},
                "buf": {n: _to_cpu(opt.state[p]["momentum_buffer"])
                        for n, p in named.items() if p in opt.state}}

    def _stepped(self, state, frames, labels, key):
        with self.run.spans.span(f"step[{self.images}]"):
            return self.step(state, frames, labels, key)

    def _recorder(self, phase: str, keep):
        """The step, and after the phase's steps 1-3 what ``check``
        compares, each tensor kept by ``keep``."""
        rec, first = self.record[phase], self.state.step

        def step(state, frames, labels, key):
            state, m = self._stepped(state, frames, labels, key)
            n = state.step - first
            if n <= 3:
                rec.setdefault("loss", []).append(keep(m["loss"]))
                named = dict(state.model.named_parameters())
                if n == 1:
                    opt = state.optimizer
                    rec["buf"] = {
                        name: keep(opt.state[p]["momentum_buffer"])
                        for name, p in named.items() if p in opt.state}
                if n == 3:
                    rec["p3"] = {name: keep(p) for name, p in named.items()}
            return state, m
        return step

    # -- the window ---------------------------------------------------------
    def window(self, seconds: float, prof) -> dict:
        from eov_tpu_torch import train as T

        run, k = self.run, self.cfg["train_segments"]
        clips = 0
        win = tracing.Window(run, prof, self.traffic["trace_seconds"])
        # the first epoch's steps 1-3 stay on the device: no sync, no copy
        step_fn = self._recorder("window", _on_device)
        while True:
            self.state, out = T.train_epoch(self.state, step_fn,
                                            self.tcfg, self.ds,
                                            epoch=self.epoch, mesh=self.mesh)
            step_fn = self._stepped
            self.epoch += 1
            clips += out["steps"] * self.tcfg.batch_clips
            if self._decide(win.lap(clips * k) >= seconds):
                break
        win.close(clips * k)
        run.counts.update(attempted=clips, failed=0)
        return {"train_clips_per_s": clips / run.window_s}

    def _decide(self, stop: bool) -> bool:
        """Rank 0's decision, on every rank."""
        if self.run.world == 1:
            return stop
        import torch.distributed as dist

        flag = torch.tensor([int(stop)], device=self.run.device)
        dist.broadcast(flag, 0)
        return bool(flag.item())

    def main_tid(self, trace):
        s = trace.scopes(self.scope)
        return s[0]["tid"] if s else None

    def release(self) -> None:
        self.record["window"] = _tree(self.record["window"], _to_cpu)
        del self.state, self.step, self.ds
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness -----------------------------------------------------
    def program_side(self, start: dict, phase: str) -> dict:
        """The phase's recorded steps as the reference's quantities: the
        gradient is the first momentum buffer less the momentum it carried
        in and the weight decay it holds."""
        rec, wd = self.record[phase], self.cfg["weight_decay"]
        buf0 = self.start["buf"] if phase == "window" else {}
        mom = self.cfg["momentum"]
        leaves, decay = ref_train.trained(self.cfg, start)
        dev = self.run.device
        grad = {}
        for n in leaves:  # no momentum yet: the optimizer got no gradient
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
        steps from them); ``kw`` as ``first_steps`` takes them (a control's
        or a fault's)."""
        dev = self.run.device
        p0 = ref_resnet.make_weights(self.cfg, self.run.seed, dev)
        train = {"batch_clips": self.traffic["batch_clips_per_chip"]
                 * self.run.world}
        if phase == "window":
            s = self.start
            p0 = {n: s["weights"][n].to(dev) for n in p0}
            kw = {"epoch": 1, "step0": s["step"], "buf0": s["buf"], **kw}
        return p0, ref_train.first_steps(
            p0, self.cfg, train, ShardSet(self.root), self.run.seed, dev,
            n_steps=3, **kw)

    def readings(self) -> dict:
        """The numbers compared, both phases."""
        import sys

        out = {}
        for phase, prefix in PHASES:
            start, ref = self.reference(phase)
            print(f"check leaves_left_out.{phase} {quiet_leaves(ref)}",
                  file=sys.stderr)
            got = gaps(self.program_side(start, phase), ref)
            out.update({prefix + k: v for k, v in got.items()})
            del start, ref
        return out

    def check(self) -> dict:
        """The readings that have a limit, each beside it; one without
        (a number with no upper reading) is printed and not compared."""
        import sys

        limits = self.run.cell.limits
        out = {}
        for k, v in self.readings().items():
            if k in limits:
                out[k] = (v, limits[k])
            else:
                print(f"check {k} {v!r} not compared", file=sys.stderr)
        return out


def _to_cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _on_device(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone()


def _tree(rec: dict, fn) -> dict:
    return {k: (_tree(v, fn) if isinstance(v, dict) else
                [fn(x) for x in v] if isinstance(v, list) else fn(v))
            for k, v in rec.items()}
