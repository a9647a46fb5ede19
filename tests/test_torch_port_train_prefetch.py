"""``train.train_epoch``'s stacking thread, on the CPU.

The batches, labels and step keys that ``step_fn`` receives are held bit
for bit against a serial replica of the loop as it ran before the thread
(order, TSN indices, buckets per resolution, wrap-padded tails, key
split), for RAW EOVC shards, an in-memory dataset of two resolutions and
the sharded loop's rows and segments. Then the failures: a read or a step
that raises, a thread that dies, and the thread gone afterwards in each
case; and the prefetch counters in the epoch's report.
"""

from __future__ import annotations

import threading
import time
import types

import numpy as np
import pytest
import torch

from eov_tpu_torch import prng
from eov_tpu_torch import train as tr
from eov_tpu_torch.data.datasets import (EovcVideoDataset,
                                         SyntheticVideoDataset)
from eov_tpu_torch.parallel.mesh import Mesh
from eov_tpu_torch.tools.pack_eovc import pack

THREAD = "eov-train-prefetch"


def _cfg(**kw) -> tr.TrainConfig:
    base = dict(num_classes=3, arch="resnet18", num_segments=3,
                batch_clips=4, seed=5)
    return tr.TrainConfig(**{**base, **kw})


def _state() -> types.SimpleNamespace:
    """What the loop reads of a state: the model's device, and the
    parameters and momentum ``sync_state`` broadcasts."""
    model = torch.nn.Linear(2, 2)
    return types.SimpleNamespace(
        model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1))


def serial_batches(cfg: tr.TrainConfig, dataset, epoch: int) -> list:
    """The single-process loop read serially: each clip's TSN indices
    drawn right after its read's predecessor, a batch whenever a
    resolution's bucket fills, then the tails wrap-padded in the buckets'
    order, the step key split once a batch. [(frames, labels, key)]."""
    rng = np.random.default_rng(cfg.seed + epoch)
    order = rng.permutation(len(dataset.records))
    key = prng.key(cfg.seed + epoch)
    out = []

    def emit(clips, labels):
        nonlocal key
        key, sub = prng.split(key, 2).unbind(0)
        out.append((np.stack(clips), list(labels), sub.tolist()))

    buckets: dict = {}
    for i in order:
        r = dataset.records[i]
        clip = dataset.get_frames(r, tr._tsn_train_indices(
            rng, r.num_frames, cfg.num_segments))
        clips, labels = buckets.setdefault(clip.shape[1:3], ([], []))
        clips.append(clip)
        labels.append(r.label)
        if len(clips) == cfg.batch_clips:
            emit(clips, labels)
            clips.clear()
            labels.clear()
    for clips, labels in buckets.values():
        if clips:
            n0 = len(clips)
            for j in range(cfg.batch_clips - n0):
                clips.append(clips[j % n0])
                labels.append(labels[j % n0])
            emit(clips, labels)
    return out


def recorder(seen: list, fail_at: int | None = None):
    """A step that copies what it receives at the call."""
    def step(state, frames, labels, key):
        if fail_at is not None and len(seen) == fail_at:
            raise RuntimeError("step failed")
        seen.append((frames.numpy().copy(), labels.tolist(), key.tolist()))
        return state, {"loss": torch.tensor(0.5)}
    return step


def assert_same(got: list, want: list) -> None:
    assert len(got) == len(want)
    for s, ((f, lab, key), (wf, wlab, wkey)) in enumerate(zip(got, want)):
        assert f.dtype == wf.dtype == np.uint8, s
        np.testing.assert_array_equal(f, wf, err_msg=f"batch {s}")
        assert (lab, key) == (wlab, wkey), s


def no_producer() -> bool:
    return not any(t.name == THREAD for t in threading.enumerate())


class TwoResolutions:
    """Seeded uint8 clips whose resolution changes every few records, so
    that the two buckets fill in turn."""

    def __init__(self, n: int):
        self.class_names = ["a", "b", "c"]
        self.records = [types.SimpleNamespace(
            video_id=f"v{i}", num_frames=4 + i % 5, label=i % 3)
            for i in range(n)]

    def get_frames(self, record, indices):
        i = int(record.video_id[1:])
        h, w = (24, 32) if (i // 2) % 2 else (32, 24)
        clip = np.random.default_rng(i).integers(
            0, 256, (record.num_frames, h, w, 3), dtype=np.uint8)
        return clip[np.asarray(indices)]


@pytest.fixture
def shards(tmp_path) -> EovcVideoDataset:
    src = SyntheticVideoDataset(n_classes=3, clips_per_class=3, height=20,
                                width=28, min_frames=5, max_frames=9, seed=2)
    path = str(tmp_path / "s.eovc")
    pack(src, path, storage_short_side=None)
    return EovcVideoDataset(path, prefer_native=False)


def test_eovc_batches_match_the_serial_loop(shards):
    """9 clips at batch 4: two full batches and a tail of one padded to
    four, over two epochs."""
    cfg = _cfg()
    for epoch in (3, 4):
        seen = []
        _, out = tr.train_epoch(_state(), recorder(seen), cfg, shards,
                                epoch=epoch)
        assert_same(seen, serial_batches(cfg, shards, epoch))
        assert (out["steps"], out["clips"]) == (3, 9)
        assert no_producer()


def test_two_resolutions_interleave_as_the_serial_loop():
    """15 clips at batch 3: 8 of one resolution, 7 of the other, so both
    buckets fill in turn and both end in a padded tail, the tails in the
    order the buckets first appeared (here not the order they last
    filled)."""
    ds = TwoResolutions(15)
    cfg = _cfg(batch_clips=3, num_segments=2)
    want = serial_batches(cfg, ds, 1)
    shapes = [w[0].shape[2:4] for w in want]
    assert len(set(shapes)) == 2 and shapes != sorted(shapes)  # in turn
    seen = []
    _, out = tr.train_epoch(_state(), recorder(seen), cfg, ds, epoch=1)
    assert_same(seen, want)
    assert (out["steps"], out["clips"]) == (len(want), 15) == (6, 15)


@pytest.mark.parametrize("n_data,n_frame", [(2, 1), (2, 3)])
def test_sharded_rows_and_segments(n_data, n_frame):
    """Each rank of the mesh receives its rows and segments of the
    single-process loop's batches, with the same keys. The mesh has no
    process group, so its collectives are the identity."""
    ds = SyntheticVideoDataset(n_classes=3, clips_per_class=3, height=20,
                               width=28, seed=6)  # 9 clips, one resolution
    cfg = _cfg(batch_clips=4)
    want = serial_batches(cfg, ds, 2)
    b = cfg.batch_clips // n_data
    k = cfg.num_segments // n_frame
    for rank in range(n_data * n_frame):
        mesh = Mesh(n_data, n_frame, rank)
        d, f = mesh.data_index, mesh.frame_index
        seen = []
        _, out = tr.train_epoch(_state(), recorder(seen), cfg, ds, epoch=2,
                                mesh=mesh)
        assert_same(seen, [(fr[d * b:(d + 1) * b, f * k:(f + 1) * k],
                            lab[d * b:(d + 1) * b], key)
                           for fr, lab, key in want])
        assert (out["steps"], out["clips"]) == (3, 9)
        assert no_producer()


def test_sharded_resolution_mismatch_raises_on_the_caller():
    ds = TwoResolutions(8)
    with pytest.raises(ValueError, match="resolution-normalized"):
        tr.train_epoch(_state(), recorder([]), _cfg(num_segments=2), ds,
                       epoch=0, mesh=Mesh(2, 1, 0))
    assert no_producer()


class FailingRead(TwoResolutions):
    def __init__(self):
        super().__init__(13)
        self.reads = 0

    def get_frames(self, record, indices):
        self.reads += 1
        if self.reads == 5:
            raise OSError("bad shard")
        return super().get_frames(record, indices)


@pytest.mark.parametrize("mesh", [None, Mesh(2, 1, 1)])
def test_a_failed_read_is_raised_by_train_epoch(mesh):
    ds = FailingRead()
    ds.get_frames = lambda r, i, g=ds.get_frames: g(
        r, i)[:, :24, :24]  # one resolution, for the sharded loop
    with pytest.raises(OSError, match="bad shard"):
        tr.train_epoch(_state(), recorder([]), _cfg(batch_clips=2,
                                                    num_segments=2),
                       ds, epoch=0, mesh=mesh)
    assert no_producer()


@pytest.mark.parametrize("mesh", [None, Mesh(2, 1, 0)])
def test_a_failed_step_stops_and_joins_the_producer(mesh):
    ds = SyntheticVideoDataset(n_classes=3, clips_per_class=4, height=20,
                               width=28, seed=1)
    seen = []
    with pytest.raises(RuntimeError, match="step failed"):
        tr.train_epoch(_state(), recorder(seen, fail_at=1),
                       _cfg(batch_clips=2), ds, epoch=0, mesh=mesh)
    assert len(seen) == 1
    assert no_producer()


def test_a_dead_producer_is_detected(monkeypatch):
    """A stacking thread that ends without stacking: the loop raises
    instead of waiting for ever."""
    monkeypatch.setattr(tr._Stacker, "_stack", lambda self: None)
    ds = SyntheticVideoDataset(n_classes=2, clips_per_class=2, height=20,
                               width=28)
    with pytest.raises(RuntimeError, match="prefetch thread died"):
        tr.train_epoch(_state(), recorder([]), _cfg(), ds, epoch=0)
    assert no_producer()


def test_prefetch_counters_in_the_report(shards):
    """Every batch handed over is counted, and the ones already stacked
    when the step asked are among them: a batch stacks while the step
    before it runs, here a step that sleeps."""
    def step(state, frames, labels, key):
        time.sleep(0.05)
        return state, {}

    _, out = tr.train_epoch(_state(), step, _cfg(), shards, epoch=0)
    c = out["report"]["counters"]
    assert c["train.prefetch.batches"] == out["steps"] == 3
    assert 1 <= c.get("train.prefetch.ready", 0) <= 3
    assert out["report"]["spans"]["read"]["n"] == 9  # a read a clip
    assert no_producer()
