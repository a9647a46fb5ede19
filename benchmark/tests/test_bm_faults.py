"""Each fault a cell can have, planted under a run on the CPU at a tiny
size, turns ``correct`` false; the same run without it is correct.

The run skips the harness's look for a chip (``run_cell`` on the CPU) and
drives the rest: set-up, window, check. Faults: a step that returns its
state unchanged; half of each batch left out, the mean taken over the rest;
SGD's momentum dropped at an epoch's start; every epoch in epoch 0's order;
on several chips, the gradient exchange left out; in extraction, half of the
segments left out of the mean, half of the clips left out of the store, and
one stored answer altered.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue

import pytest
import torch

from benchmark import run as R
from benchmark.tests.conftest import tiny_cell

SEED = 2 ** 31 + 21
LOOSE = {"loss_gap": 0.2, "grad_gap": 0.2, "update_gap": 0.2,
         "window_loss_gap": 0.2, "window_grad_gap": 0.2,
         "window_update_gap": 0.2, "feature_gap": 0.2, "missing_clips": 0}


def _run(cell, root, world=1, rank=0, port=0):
    return R.run_cell(cell, SEED, 1, False, "cpu", root=str(root),
                      rank=rank, world=world, port=port)


def _half_batch(monkeypatch):
    from eov_tpu_torch import train as T

    real = T.make_train_step

    def make(cfg, device="cuda", mesh=None):
        step = real(cfg, device, mesh)

        def half(state, frames, labels, key):
            b = frames.shape[0] // 2
            return step(state, frames[:b], labels[:b], key)
        return half
    monkeypatch.setattr(T, "make_train_step", make)


def _unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None:
                        None)


def _momentum_reset(monkeypatch):
    """SGD's momentum dropped at each epoch's start."""
    from eov_tpu_torch import train as T

    real = T.train_epoch

    def epoch(state, *a, **kw):
        state.optimizer.state.clear()
        return real(state, *a, **kw)
    monkeypatch.setattr(T, "train_epoch", epoch)


def _epoch_repeated(monkeypatch):
    """Every epoch run in epoch 0's order, with its keys."""
    from eov_tpu_torch import train as T

    real = T.train_epoch
    monkeypatch.setattr(T, "train_epoch", lambda *a, **kw: real(
        *a, **dict(kw, epoch=0)))


@pytest.mark.parametrize("cell_name", ["r50_finetune", "r34_finetune"])
def test_train_sound(tmp_path, cell_name):
    assert _run(tiny_cell(cell_name, **LOOSE), tmp_path)["correct"]


@pytest.mark.parametrize("cell_name", ["r50_finetune", "r34_finetune"])
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _momentum_reset,
                                   _epoch_repeated])
def test_train_faults(tmp_path, monkeypatch, cell_name, fault):
    fault(monkeypatch)
    got = _run(tiny_cell(cell_name), tmp_path)
    assert got["correct"] is False, got["checks"]


def _altered(monkeypatch):
    from eov_tpu_torch.data.store import FeatureStore

    real = FeatureStore.put

    def put(self, video_id, feature, label):
        if video_id.endswith("_v01"):
            feature = feature * 1.1
        real(self, video_id, feature, label)
    monkeypatch.setattr(FeatureStore, "put", put)


def _half_clips(monkeypatch):
    from eov_tpu_torch.data.store import FeatureStore

    real = FeatureStore.put

    def put(self, video_id, feature, label):
        if not video_id.endswith("_v01"):
            real(self, video_id, feature, label)
    monkeypatch.setattr(FeatureStore, "put", put)


def _half_segments(monkeypatch):
    from eov_tpu_torch import extract as E

    real = E.make_segment_fn

    def make(weights, cfg, device="cuda", act_max=None):
        fn = real(weights, cfg, device, act_max=act_max)
        return lambda frames: fn(frames)[:, :cfg.num_segments // 2]
    monkeypatch.setattr(E, "make_segment_fn", make)


def test_extract_sound(tmp_path):
    assert _run(tiny_cell("r50_extract", **LOOSE), tmp_path)["correct"]


@pytest.mark.parametrize("fault", [_altered, _half_clips, _half_segments])
def test_extract_faults(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    got = _run(tiny_cell("r50_extract"), tmp_path)
    assert got["correct"] is False, got["checks"]


def _rank(rank, world, port, root, fault, q):
    """One rank of the tiny multi-chip cell on the CPU (gloo), with the
    fault ``fault`` (or none) planted in this rank's program."""
    torch.set_num_threads(1)
    if fault == "no_exchange":
        from eov_tpu_torch import train as T

        T._mean_grads = lambda model, world: None
    elif fault == "unchanged":
        torch.optim.SGD.step = lambda self, closure=None: None
    elif fault == "half_batch":  # a worker process: nothing to undo
        _half_batch(pytest.MonkeyPatch())
    limits = LOOSE if fault is None else {}
    got = R.run_cell(_dp4_cell(**limits), SEED, 1, False, "cpu", root=root,
                     rank=rank, world=world, port=port)
    if rank == 0:
        q.put(got)


def _dp4_cell(**limits):
    """Four ranks of two clips: epoch 0 holds three global steps."""
    cell = tiny_cell("r50_finetune_dp4", **limits)
    cell.traffic["data"].update(clips_per_class=8)
    return cell


@pytest.mark.parametrize("fault", [None, "no_exchange", "unchanged",
                                   "half_batch"])
def test_multichip_faults(tmp_path, fault):
    world, root = 4, str(tmp_path)
    from benchmark import data

    data.shard_set(os.path.join(root, R.CACHE), _dp4_cell().traffic["data"])
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = R._free_port()
    procs = [ctx.Process(target=_rank, args=(r, world, port, root, fault, q))
             for r in range(world)]
    for p in procs:
        p.start()
    got = None
    while got is None:
        try:
            got = q.get(timeout=1)
        except queue.Empty:
            assert all(p.exitcode in (None, 0) for p in procs), \
                [p.exitcode for p in procs]
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    assert got["correct"] is (fault is None), got["checks"]
