"""``utils/trace.py``: spans, counters, reports and device gaps, on the CPU.

The device gaps need CUDA events; here a clock is injected in their place,
which plants the gap each pair of events reads. ``train_epoch`` and
``extract_features`` run over small RAW EOVC shards, and their reports
carry the spans and counters the benchmark's readers take.
"""

from __future__ import annotations

import json
import os
import threading
import time

import pytest
import torch

from eov_tpu_torch import cli, extract, prng
from eov_tpu_torch import train as tr
from eov_tpu_torch.data.datasets import (EovcVideoDataset,
                                         SyntheticVideoDataset)
from eov_tpu_torch.data.store import MemoryFeatureStore
from eov_tpu_torch.models.resnet import random_state_dict
from eov_tpu_torch.ops import (bottleneck, bottleneck_int8, bottleneck_train,
                               crop_normalize, pool, similarity)
from eov_tpu_torch.tools.pack_eovc import pack
from eov_tpu_torch.utils import trace
from eov_tpu_torch.utils.metrics import MetricsWriter

H, W, K = 40, 48, 2


class PlantedClock:
    """Events are (their number, host time); each pair reads the planted
    gap (seconds), or the gap a function of the pair gives."""

    def __init__(self, gap):
        self.gap = gap
        self.records = 0
        self.freed = 0
        self.hold = False  # events not yet reached by the "device"

    def record(self):
        self.records += 1
        return self.records, time.perf_counter()

    def done(self, ev) -> bool:
        return not self.hold

    def wait(self, ev) -> None:
        self.hold = False

    def read(self, pairs) -> list:
        self.freed += 2 * len(pairs)
        return [self.gap(c, o) if callable(self.gap) else self.gap
                for c, o in pairs]


@pytest.fixture
def planted():
    clocks = []

    def use(gap):
        clock = PlantedClock(gap)
        clocks.append(clock)
        trace.set_event_clock(lambda dev: clock)
        return clock

    yield use
    trace.set_event_clock(None)


def _shards(tmp_path, classes=3, clips=3) -> EovcVideoDataset:
    src = SyntheticVideoDataset(n_classes=classes, clips_per_class=clips,
                                height=H, width=W, min_frames=6,
                                max_frames=10, seed=4)
    path = str(tmp_path / "s.eovc")
    pack(src, path, storage_short_side=None)
    return EovcVideoDataset(path)


def test_span_nesting_self_time_and_step_ids():
    """Parents, threads, times, self time (duration less the children),
    the step id the spans of one step share, and the folded summary."""
    seen = []
    with trace.root("unit.epoch", 7) as r:
        for _ in range(2):
            with trace.span("outer") as outer:
                with trace.span("inner", device=True) as inner:
                    time.sleep(0.002)
                time.sleep(0.001)
            seen.append((outer, inner))
            trace.step()
    (o1, i1), (o2, i2) = seen
    assert i1.parent is o1 and o1.parent is r and r.parent is None
    assert i1.thread == o1.thread == threading.get_ident()
    assert o1.t0 <= i1.t0 < i1.t1 <= o1.t1 <= o2.t0
    assert (o1.step, i1.step) == ((7, 0), (7, 0))
    assert (o2.step, i2.step) == ((7, 1), (7, 1))
    rep = r.report
    assert (rep["kind"], rep["name"], rep["epoch"], rep["steps"]) == (
        "unit", "unit.epoch", 7, 2)
    assert rep["wall_s"] == pytest.approx(r.t1 - r.t0)
    assert rep["profiled"] is False and rep["device_gap_s"] is None
    spans = rep["spans"]
    assert spans["inner"]["n"] == spans["outer"]["n"] == 2
    dur = lambda s: s.t1 - s.t0  # noqa: E731
    assert spans["inner"]["s"] == pytest.approx(dur(i1) + dur(i2))
    assert spans["outer"]["self_s"] == pytest.approx(
        dur(o1) - dur(i1) + dur(o2) - dur(i2))
    assert spans["unit.epoch"]["self_s"] == pytest.approx(
        dur(r) - dur(o1) - dur(o2))
    assert spans["outer"]["self_s"] >= 0.0019


def test_spans_of_other_threads_fold_into_the_root():
    """A worker thread's spans (the decode thread's) fold into the open
    root; they have no parent on their own thread."""
    got = {}

    def work():
        with trace.span("read") as s:
            trace.count("unit.bytes", 5)
            time.sleep(0.001)
        got["span"] = s

    with trace.root("unit.pass") as r:
        t = threading.Thread(target=work)
        t.start()
        t.join()
    assert got["span"].parent is None and got["span"].step == (r.number, 0)
    assert got["span"].thread != threading.get_ident()
    assert r.report["spans"]["read"]["n"] == 1
    assert r.report["counters"]["unit.bytes"] == 5


def test_threads_lose_no_update():
    """Many threads opening spans and counting inside one root, with the
    interpreter switching threads as often as it can: every span is
    folded and every count kept."""
    import sys

    n_threads, n = 16, 300
    c0 = trace.counter("unit.stress")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.root("unit.stress") as r:
            def work():
                for _ in range(n):
                    with trace.span("stress"):
                        trace.count("unit.stress")
                        trace.count("unit.stress2", 2)

            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for _ in range(n):  # the root's own thread as well
                with trace.span("stress"):
                    trace.count("unit.stress")
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    total = (n_threads + 1) * n
    assert r.report["spans"]["stress"]["n"] == total
    assert r.report["counters"]["unit.stress"] == total
    assert r.report["counters"]["unit.stress2"] == 2 * n_threads * n
    assert trace.counter("unit.stress") == c0 + total


def test_counters_and_bounded_reports():
    """Counters add from any thread and survive their thread; a report
    holds each counter's increment over its root; the list keeps the most
    recent MAX_REPORTS reports, oldest first."""
    c0 = trace.counter("unit.n")
    t = threading.Thread(target=trace.count, args=("unit.n", 3))
    t.start()
    t.join()
    trace.count("unit.n")
    assert trace.counter("unit.n") == c0 + 4
    assert trace.counters()["unit.n"] == c0 + 4
    for i in range(trace.MAX_REPORTS + 5):
        with trace.root("unit.many", i):
            trace.count("unit.n", 2)
    reps = trace.reports()
    assert len(reps) == trace.MAX_REPORTS
    assert [r["epoch"] for r in reps[-3:]] == [trace.MAX_REPORTS + 2,
                                               trace.MAX_REPORTS + 3,
                                               trace.MAX_REPORTS + 4]
    assert all(r["counters"] == {"unit.n": 2} for r in reps[-5:])
    assert trace.counter("unit.absent") == 0


def test_profiled_flag_and_profiler_annotations(tmp_path):
    """Under a CPU torch.profiler each span of a train epoch is an
    ``eov.<name>`` annotation of the Chrome trace, nested as the spans
    are, and the epoch's report says it was profiled; a root outside the
    profiler says not."""
    ds = _shards(tmp_path, classes=2, clips=2)
    cfg = tr.TrainConfig(num_classes=2, arch="resnet18", num_segments=K,
                         batch_clips=4, scale_size=36, crop_size=32,
                         compute_dtype="float32", seed=3)
    state = tr.create_train_state(cfg, "cpu")
    tdir = str(tmp_path / "t")
    with trace.trace(tdir, "cpu"):
        _, out = tr.train_epoch(state, tr.make_train_step(cfg, "cpu"), cfg,
                                ds, epoch=0)
    with trace.root("unit.epoch", 1) as quiet:
        pass
    assert out["report"]["profiled"] is True
    assert quiet.report["profiled"] is False
    with open(os.path.join(tdir, trace.META)) as f:
        meta = json.load(f)
    with open(os.path.join(tdir, meta["trace"])) as f:
        events = json.load(f)["traceEvents"]
    ann = {e["name"]: e for e in events
           if e.get("ph") == "X" and e["name"].startswith("eov.")}
    assert {"eov.train.epoch", "eov.read", "eov.train.batch",
            "eov.train.step", "eov.train.keys", "eov.train.forward",
            "eov.train.backward", "eov.train.optimizer"} <= set(ann)

    def inside(a, b):
        return (b["ts"] <= a["ts"]
                and a["ts"] + a["dur"] <= b["ts"] + b["dur"]
                and a["tid"] == b["tid"])

    for name in ("eov.train.keys", "eov.train.forward",
                 "eov.train.optimizer"):
        assert inside(ann[name], ann["eov.train.step"]), name
    assert inside(ann["eov.train.step"], ann["eov.train.epoch"])


def test_attribute_splits_a_gap_by_overlap():
    """The gap [t_o - g, t_o] is put down to the labels over it in
    proportion to their overlap, clipped at the interval's start and at
    the root's."""
    timeline = [(1.0, "a"), (2.0, "b"), (2.5, "a"), (3.0, "c")]
    out = {}
    assert trace.attribute(1.5, 1.0, 3.5, timeline, 0.0, out) == 1.5
    assert out == pytest.approx({"b": 0.5, "a": 0.5, "c": 0.5})
    out = {}
    assert trace.attribute(9.0, 1.0, 3.5, timeline, 0.0, out) == 2.5
    assert out == pytest.approx({"a": 1.5, "b": 0.5, "c": 0.5})
    out = {}
    assert trace.attribute(9.0, 1.0, 3.5, timeline, 2.2, out) == (
        pytest.approx(1.3))
    assert out == pytest.approx({"b": 0.3, "a": 0.5, "c": 0.5})
    assert trace.attribute(0.0, 1.0, 3.5, timeline, 0.0, {}) == 0.0


def test_planted_gap_before_a_device_span(planted):
    """A gap of g that ends as a device span opens is put down to the
    host-only spans covering [T_o - g, T_o]: here the last part of
    ``host.a`` and all of ``host.b``; device spans that follow each other
    directly record no event, and a host span inside a device span is
    host-only work of its own."""
    g = 0.004
    # events: 1 the root's open, 2 `launch`, 3 `host.a`, 4 `dev.1`, 5 and 6
    # around `host.c`: the gap is planted in the stretch from 3 to 4
    clock = planted(lambda c, o: g if c[0] == 3 else 0.0)
    with trace.root("unit.epoch", 0, "cpu") as r:
        with trace.span("launch", device=True):
            pass
        with trace.span("host.a") as a:
            time.sleep(0.003)
        with trace.span("host.b") as b:
            time.sleep(0.0025)
        with trace.span("dev.1", device=True) as d1:
            with trace.span("host.c"):
                time.sleep(0.001)
        with trace.span("dev.2", device=True):
            pass
    t_o = d1.t0

    def overlap(s):  # of [t_o - g, t_o]
        return max(0.0, min(s.t1, t_o) - max(s.t0, t_o - g))

    got = r.report["device_gap_by_span"]
    assert r.report["device_gap_s"] == pytest.approx(g, rel=1e-6)
    assert got.get("host.a", 0.0) == pytest.approx(overlap(a), abs=1e-9)
    assert got.get("host.b", 0.0) == pytest.approx(overlap(b), abs=1e-9)
    assert got["host.b"] > 0  # the 2.5 ms before the device span
    assert got["unit.epoch"] == pytest.approx(
        g - overlap(a) - overlap(b), abs=1e-9)  # between the spans
    assert "host.c" not in got  # its stretch read no gap
    # root open, launch, host.b -> dev.1 open, host.c in and out, dev.2
    # after dev.1 directly (no event), the root's close
    assert clock.records == 6 and clock.freed == 6


def test_a_raising_root_reads_no_gap(planted):
    """A root whose block raises still reports its spans, reads no gap
    (the stream may hold the fault), and leaves no root open."""
    planted(0.001)
    with pytest.raises(RuntimeError):
        with trace.root("unit.epoch", 0, "cpu") as r:
            with trace.span("dev", device=True):
                raise RuntimeError("fault")
    assert r.report["device_gap_s"] is None
    assert r.report["spans"]["dev"]["n"] == 1
    with trace.span("after") as after:
        pass
    assert after.step is None and after.parent is None


def test_gaps_resolve_as_they_complete(planted):
    """Gaps in flight are read once the newest has completed, so a long
    epoch holds few; while it has not, they wait (for the root's close
    here). The sum is the same either way."""
    clock = planted(0.0001)
    n = 150
    with trace.root("unit.epoch", 0, "cpu") as r:
        for i in range(n):
            clock.hold = i >= 100
            with trace.span("host"):
                time.sleep(0.0002)
            with trace.span("dev", device=True):
                pass
            if i == 99:
                early = clock.freed
        late = clock.freed
    assert early >= 2 * 64 and late == early  # none read while held
    assert clock.freed == 2 * n  # a pair a host-only stretch
    assert r.report["device_gap_s"] == pytest.approx(n * 0.0001, rel=1e-6)
    assert r.report["device_gap_by_span"]["host"] > 0


def test_train_epoch_report(tmp_path):
    """A train_epoch over RAW shards: the report carries the loop's and
    the step's spans, the reader's bytes and clips, and the images."""
    ds = _shards(tmp_path)
    cfg = tr.TrainConfig(num_classes=3, arch="resnet18", num_segments=K,
                         batch_clips=4, scale_size=36, crop_size=32,
                         compute_dtype="float32", seed=3)
    state = tr.create_train_state(cfg, "cpu")
    state, out = tr.train_epoch(state, tr.make_train_step(cfg, "cpu"), cfg,
                                ds, epoch=2)
    rep = out["report"]
    assert rep is trace.reports()[-1]
    assert (rep["kind"], rep["name"], rep["epoch"]) == ("train",
                                                        "train.epoch", 2)
    assert rep["steps"] == out["steps"] == 3
    spans = rep["spans"]
    for name in ("train.epoch", "read", "train.batch", "train.step",
                 "train.keys", "train.h2d", "train.augment", "train.forward",
                 "train.backward", "train.optimizer"):
        assert spans[name]["n"] >= 1, name
    assert out["clips"] == 9
    assert spans["read"]["n"] == 9  # a clip a read
    assert spans["train.step"]["n"] == 3
    assert spans["train.keys"]["n"] == 9  # the split, the crops, dropout
    c = rep["counters"]
    assert c["eovc.clips"] == 9
    assert c["eovc.bytes"] == 9 * K * H * W * 3
    assert c["train.images"] == 3 * 4 * K
    assert rep["device_gap_s"] is None and not rep["profiled"]


def test_train_step_launches_before_its_draws(monkeypatch):
    """A train step launches the frames' H2D, then splits the keys, then
    launches the resize before it draws the crops: the draws and the
    dropout seed are ``train.keys`` spans inside ``train.augment``, so the
    device works while the host draws."""
    from eov_tpu_torch.ops import resize as resize_ops

    log = []
    enter, resize = trace.span.__enter__, resize_ops.resize_short_side

    def spy(self):
        out = enter(self)
        parent = self.parent
        log.append((self.name, parent.name if parent is not None else None))
        return out

    def logged_resize(*args, **kwargs):
        log.append(("resize", None))
        return resize(*args, **kwargs)

    monkeypatch.setattr(trace.span, "__enter__", spy)
    monkeypatch.setattr(resize_ops, "resize_short_side", logged_resize)
    cfg = tr.TrainConfig(num_classes=3, arch="resnet18", num_segments=K,
                         batch_clips=2, scale_size=36, crop_size=32,
                         compute_dtype="float32", dropout=0.5, seed=3)
    state = tr.create_train_state(cfg, "cpu")
    frames = torch.randint(0, 256, (2, K, H, W, 3), dtype=torch.uint8)
    step = tr.make_train_step(cfg, "cpu")
    with trace.root("unit.epoch", 0):
        step(state, frames, torch.tensor([0, 1]), prng.key(0))
    assert [e for e in log if e[0] != "unit.epoch"] == [
        ("train.step", "unit.epoch"), ("train.h2d", "train.step"),
        ("train.augment", "train.step"), ("train.keys", "train.augment"),
        ("resize", None), ("train.keys", "train.augment"),
        ("train.keys", "train.augment"), ("train.forward", "train.step"),
        ("train.backward", "train.step"), ("train.optimizer", "train.step")]


def test_extract_pass_report(tmp_path):
    """An extract_features pass over RAW shards (the decode thread and the
    pooled reader): the report carries the pass's spans and counters; the
    metrics file holds it in ``extract_done``, and each batch's seconds."""
    ds = _shards(tmp_path)
    cfg = extract.ExtractConfig(arch="resnet18", num_segments=K,
                                batch_clips=4, scale_size=H, crop_size=32,
                                compute_dtype="float32")
    fn = extract.make_feature_fn(random_state_dict("resnet18", seed=0), cfg,
                                 "cpu")
    path = str(tmp_path / "m.jsonl")
    metrics = MetricsWriter(path)
    stats = extract.extract_features(ds, None, MemoryFeatureStore(
        class_names=ds.class_names), cfg, metrics, feature_fn=fn,
        device="cpu")
    metrics.close()
    rep = stats["report"]
    assert (rep["kind"], rep["name"]) == ("extract", "extract.pass")
    spans = rep["spans"]
    for name in ("extract.pass", "extract.decode", "read", "extract.wait",
                 "extract.features", "extract.d2h", "extract.store"):
        assert spans[name]["n"] >= 1, name
    assert spans["extract.decode"]["n"] == spans["read"]["n"] == 3
    assert spans["extract.features"]["n"] == rep["steps"] == 3
    c = rep["counters"]
    assert c["eovc.clips"] == 9 and c["eovc.bytes"] == 9 * K * H * W * 3
    assert c["extract.images"] == 9 * K
    with open(path) as f:
        events = [json.loads(line) for line in f]
    batches = [e for e in events if e["event"] == "extract_batch"]
    done = [e for e in events if e["event"] == "extract_done"]
    assert len(batches) == 3 and all(e["seconds"] > 0 for e in batches)
    assert sum(e["seconds"] for e in batches) <= rep["wall_s"]
    assert done[0]["report"]["counters"] == c


def test_cli_train_writes_the_epoch_report(tmp_path, capsys):
    """``train --metrics``: each ``epoch`` event holds its report."""
    path = str(tmp_path / "m.jsonl")
    assert cli.main([
        "train", "--device", "cpu", "--synthetic-classes", "3",
        "--synthetic-clips", "2", "--synthetic-height", "40",
        "--synthetic-width", "48", "--scale-size", "36", "--crop-size",
        "32", "--batch", "2", "--num-segments", "2", "--arch", "resnet18",
        "--epochs", "1", "--metrics", path]) == 0
    assert "report" not in capsys.readouterr().out
    with open(path) as f:
        epochs = [e for e in map(json.loads, f) if e["event"] == "epoch"]
    assert len(epochs) == 1
    rep = epochs[0]["report"]
    assert rep["kind"] == "train" and rep["steps"] == epochs[0]["steps"]
    assert rep["spans"]["train.step"]["n"] == epochs[0]["steps"]


def test_launch_counters_replace_the_wrapper_attributes():
    """Launches are counted as ``launch.<wrapper>`` in the registry; the
    wrappers carry no counter of their own, and their plain versions on
    the CPU launch nothing."""
    wrappers = (crop_normalize.crop_normalize,
                bottleneck.fused_bottleneck_stack,
                bottleneck.fused_pool_bottleneck_stack,
                bottleneck.fused_basic_stack,
                bottleneck_int8.fused_bottleneck_stack_int8,
                bottleneck_train.train_stack_forward,
                bottleneck_train.train_stack_backward,
                pool.maxpool_3x3_s2_nonneg,
                similarity.episode_class_scores)
    assert not any(hasattr(f, "launches") for f in wrappers)
    before = {f.__name__: trace.counter(f"launch.{f.__name__}")
              for f in wrappers}
    x = torch.rand(1, 8, 8, 4)
    pool.maxpool_3x3_s2_nonneg(x)
    crop_normalize.crop_normalize(torch.zeros(1, 8, 8, 3, dtype=torch.uint8),
                                  crop=4)
    assert {n: trace.counter(f"launch.{n}") for n in before} == before
