"""The readers of the program's own reports (``eov_tpu_torch.utils.trace``)
on planted reports: each takes the reports of its kind after the last
profiled one, and reads nothing without such a tail."""

from __future__ import annotations

import pytest

from benchmark import manifest

TRAIN = ("device_gap_share.train", "keys_gap_share.train",
         "loop_gap_share.train")
EXTRACT = ("device_gap_share.extract", "wait_gap_share.extract",
           "eovc_read_gbps.extract")


def _report(kind, profiled, wall, gap, by, nbytes=0, read_s=0.0):
    return {"kind": kind, "name": f"{kind}.x", "epoch": 0, "wall_s": wall,
            "profiled": profiled, "steps": 1,
            "spans": {"read": {"s": read_s, "self_s": read_s, "n": 1}},
            "counters": {"eovc.bytes": nbytes},
            "device_gap_s": gap, "device_gap_by_span": by}


@pytest.fixture
def plant(monkeypatch):
    from eov_tpu_torch.utils import trace

    def use(reports):
        monkeypatch.setattr(trace, "reports", lambda: list(reports))
    return use


def _read(name):
    return manifest.metric_reader(name)(object())


def test_train_readers_take_the_tail_after_the_last_profiled(plant):
    by = {"train.keys": 0.1, "read": 0.05, "train.batch": 0.02,
          "train.epoch": 0.03, "train.step": 0.2}
    plant([
        _report("train", False, 5.0, 4.0, {"read": 4.0}),    # warm-up
        _report("train", True, 2.0, 1.5, {"read": 1.5}),     # traced
        _report("extract", False, 1.0, 0.9, {}),             # other kind
        _report("train", True, 2.0, 1.5, {"read": 1.5}),     # traced
        _report("train", False, 1.0, 0.4, by),
        _report("train", False, 3.0, 0.8, dict(by, **{"train.keys": 0.3})),
    ])
    assert _read("device_gap_share.train") == pytest.approx(
        100 * 1.2 / 4.0)
    assert _read("keys_gap_share.train") == pytest.approx(100 * 0.4 / 4.0)
    assert _read("loop_gap_share.train") == pytest.approx(
        100 * 2 * (0.05 + 0.02 + 0.03) / 4.0)


def test_extract_readers(plant):
    plant([
        _report("extract", True, 1.0, 0.5, {"extract.wait": 0.5}, 10**9,
                1.0),
        _report("extract", False, 0.5, 0.25,
                {"extract.wait": 0.2, "extract.store": 0.05}, 2 * 10**9,
                0.4),
        _report("extract", False, 0.5, 0.15, {"extract.wait": 0.1},
                10**9, 0.2),
    ])
    assert _read("device_gap_share.extract") == pytest.approx(40.0)
    assert _read("wait_gap_share.extract") == pytest.approx(30.0)
    assert _read("eovc_read_gbps.extract") == pytest.approx(3e9 / 0.6 / 1e9)


@pytest.mark.parametrize("reports", [
    [],                                                      # no reports
    [_report("train", False, 1.0, 0.5, {}),                  # none profiled
     _report("extract", False, 1.0, 0.5, {})],
    [_report("train", False, 1.0, 0.5, {}),                  # no tail
     _report("train", True, 1.0, 0.5, {}),
     _report("extract", False, 1.0, 0.5, {}),
     _report("extract", True, 1.0, 0.5, {})],
])
def test_nothing_without_a_tail(plant, reports):
    plant(reports)
    for name in TRAIN + EXTRACT:
        assert _read(name) is None, name


def test_no_gaps_on_the_cpu(plant):
    """A report without device gaps (the CPU) gives no gap share; the read
    rate stays."""
    plant([_report("extract", True, 1.0, None, None, 10, 1.0),
           _report("extract", False, 1.0, None, None, 10**9, 0.5)])
    assert _read("device_gap_share.extract") is None
    assert _read("wait_gap_share.extract") is None
    assert _read("eovc_read_gbps.extract") == pytest.approx(2.0)


def test_a_program_without_reports(monkeypatch):
    """A program that keeps no reports (an older port): nothing, no error."""
    from eov_tpu_torch.utils import trace

    monkeypatch.delattr(trace, "reports")
    for name in TRAIN + EXTRACT:
        assert _read(name) is None, name


def test_a_real_pass_is_read(tmp_path):
    """A profiled pass then an unprofiled one through the program on the
    CPU: the read rate comes from the second alone; the gap shares need
    the card."""
    import torch.profiler

    from eov_tpu_torch import extract
    from eov_tpu_torch.data.datasets import (EovcVideoDataset,
                                             SyntheticVideoDataset)
    from eov_tpu_torch.data.store import MemoryFeatureStore
    from eov_tpu_torch.tools.pack_eovc import pack
    from eov_tpu_torch.utils import trace

    src = SyntheticVideoDataset(n_classes=2, clips_per_class=2, height=32,
                                width=40, min_frames=4, max_frames=6)
    pack(src, str(tmp_path / "s.eovc"), storage_short_side=None)
    ds = EovcVideoDataset(str(tmp_path / "s.eovc"))
    cfg = extract.ExtractConfig(num_segments=2, batch_clips=2)

    def run_pass():
        return extract.extract_features(
            ds, None, MemoryFeatureStore(class_names=ds.class_names), cfg,
            feature_fn=lambda x: x.float().mean(dim=(1, 2, 3)),
            device="cpu")["report"]

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        first = run_pass()
    second = run_pass()
    assert first["profiled"] and not second["profiled"]
    assert trace.reports()[-1] is second
    want = (second["counters"]["eovc.bytes"]
            / second["spans"]["read"]["s"] / 1e9)
    assert _read("eovc_read_gbps.extract") == pytest.approx(want)
    assert _read("device_gap_share.extract") is None
