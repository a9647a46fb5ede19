"""The trace arithmetic on a hand-made Chrome trace: busy time as the union
of device intervals, kernels attributed to the scope and thread that
launched them, idle gaps labelled by what the host was doing."""

from __future__ import annotations

import pytest

from benchmark import tracing


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _doc():
    ev = [
        # host: two steps on thread 1, a backward on thread 2
        _x("user_annotation", "bench.step[96]", 0, 100),
        _x("user_annotation", "bench.step[96]", 150, 100),
        _x("user_annotation", "bench.read", 100, 50),
        _x("cpu_op", "aten::copy_", 110, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 1, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 1, 2, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 160, 1, 1, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 290, 1, 1, corr=4),
        # device: overlapping kernels, a memcpy, one launched outside
        _x("kernel", "void (anonymous namespace)::train_fwd_bf16(Args)", 20,
           30, 7, corr=1),
        _x("kernel", "void (anonymous namespace)::train_fwd_bf16(Args)", 40,
           40, 8, corr=2),
        _x("gpu_memcpy", "Memcpy HtoD", 90, 5, 7),
        _x("kernel", "void (anonymous namespace)::train_fwd_bf16(Args)", 170,
           20, 7, corr=3),
        _x("kernel", "sm90_xmma_gemm", 300, 10, 7, corr=4),
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0},
    ]
    return {"traceEvents": ev}


def test_union():
    assert tracing.union_us([(0, 10), (5, 15), (20, 30), (22, 25)]) == 25
    assert tracing.union_us([]) == 0
    assert tracing.merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]


def test_busy_and_names():
    tr = tracing.Trace(_doc(), 400e-6)
    # [20, 80] + [90, 95] + [170, 190] + [300, 310]
    assert tr.busy_s == pytest.approx(95e-6)
    names = dict(tr.by_name())
    assert names["sm90_xmma_gemm"] == pytest.approx(10e-6)
    assert tr.seconds_of(lambda n: "train_fwd" in n) == pytest.approx(90e-6)


def test_scopes_and_threads():
    tr = tracing.Trace(_doc(), 400e-6)
    scopes = tr.scopes("step")
    assert [s["n"] for s in scopes] == [96, 96]
    fwd = lambda n: "train_fwd_bf16" in n  # noqa: E731
    s, hit = tr.kernels_in(scopes, fwd, "same")
    assert s == pytest.approx(50e-6) and len(hit) == 2
    s, hit = tr.kernels_in(scopes, fwd, "other")
    assert s == pytest.approx(40e-6) and len(hit) == 1
    s, hit = tr.kernels_in(scopes, lambda n: "gemm" in n, "any")
    assert s == 0 and hit == []  # launched after the last scope closed


def test_idle_gaps():
    tr = tracing.Trace(_doc(), 400e-6)
    gaps = dict(tr.idle_gaps(1))
    # 80-90 inside step 1 (no op), 95-170: mid 132.5 in bench.read, no op
    # (aten::copy_ ends at 130), 190-300: mid 245 in step 2
    assert gaps == pytest.approx({"bench.step / python": 120e-6,
                                  "bench.read / python": 75e-6})


class _Prof:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def stop(self):
        self.log.append(("stop", self.name))


class _Notes:
    """LapNotes without its clock (the collector's callback reads it)."""

    def __init__(self, spans):
        self.table = {"laps": [0]}

    def lap(self):
        self.table["laps"][0] += 1

    def close(self):
        pass


def _window_run():
    import torch

    class Run:
        device = torch.device("cpu")
        spans = tracing.Spans()
        counts: dict = {}
    return Run()


def test_window_stops_the_profiler_after_trace_s(monkeypatch):
    """The profiler stops at the first lap past ``trace_s``; the untraced
    tail, which a traced run's rates are read from, starts there."""
    clock = iter([0.0, 1.0, 2.5, 2.6, 6.0, 9.0])
    monkeypatch.setattr(tracing.time, "perf_counter", lambda: next(clock))
    monkeypatch.setattr(tracing, "LapNotes", _Notes)
    log = []
    run = _window_run()
    win = tracing.Window(run, _Prof(log, "trace"), 2.0)
    win.lap(10)   # 1.0: still tracing
    win.lap(20)   # 2.5: stops; the tail starts at 2.6
    win.lap(30)   # 6.0
    win.close(40)  # 9.0 sync, end
    assert log == [("stop", "trace")]
    assert run.tail["images"] == 20
    assert run.tail["seconds"] == pytest.approx(9.0 - 2.6)
    assert run.counts["lap_notes"] == {"laps": [3]}


def test_window_shorter_than_the_trace(monkeypatch):
    clock = iter([0.0, 0.5, 1.0])
    monkeypatch.setattr(tracing.time, "perf_counter", lambda: next(clock))
    monkeypatch.setattr(tracing, "LapNotes", _Notes)
    log = []
    run = _window_run()
    win = tracing.Window(run, _Prof(log, "trace"), 2.0)
    win.lap(10)
    win.close(10)
    assert log == [("stop", "trace")]
    assert run.tail["images"] == 10  # no untraced tail: the whole window


def test_lap_notes_count_spans_and_gc():
    import gc

    spans = tracing.Spans()
    notes = tracing.LapNotes(spans)
    with spans.span("read"):
        pass
    gc.collect()
    notes.lap()
    notes.close()
    assert notes._gc not in gc.callbacks
    t = notes.table
    assert set(t) >= {"cpu_s", "steal_s", "gc_s", "majflt", "read_s"}
    assert t["gc_s"][0] > 0 and t["read_s"][0] >= 0
