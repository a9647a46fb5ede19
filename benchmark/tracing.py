"""Host spans, the profiler around the traced window, and what is read from
its trace.

The interval arithmetic (device busy = the union of the ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` intervals) is copied from
``eov_tpu_torch/tools/profile_summary.py`` (``_union_us``, ``_DEVICE_CATS``)
at commit 1d21111.

``Spans`` sums the host time of named spans the harness opens around its
calls into the program (the reader, the step) and marks each with a
``record_function`` so that the trace shows what the host was doing.
``Trace.read`` turns a Chrome trace into the numbers the per-layer readers
take: busy time, time by kernel, the idle gaps by the host span beside
them, and the device time of given kernels launched inside given scopes.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import threading
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def union_us(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def merged(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Spans:
    """Summed host seconds of named spans, thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.seconds[name] = self.seconds.get(name, 0.0) + dt

    def reset(self) -> None:
        with self._lock:
            self.seconds.clear()


class Profiler:
    """``torch.profiler`` (CPU and CUDA activity) between ``start`` and
    ``stop``; the Chrome trace is written to ``path``. A profile of the
    device's activity alone reads every kernel's duration as 0 (PyTorch
    2.11, CUDA 12.8, H100), so the host's operators are recorded too, which
    slows the host's side of each step."""

    def __init__(self, path: str, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        self.path, self.device = path, device
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self.window_s = None

    def start(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)

    def export(self) -> "Trace":
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            doc = json.load(f)
        os.remove(self.path)
        return Trace(doc, self.window_s)


class Trace:
    """What the per-layer readers take from one traced window."""

    def __init__(self, doc: dict, window_s: float):
        events = [e for e in doc.get("traceEvents", ())
                  if e.get("ph") == "X" and "dur" in e]
        self.window_s = window_s
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in self.device]
        self.busy_s = union_us(spans) / 1e6
        self._busy = merged(spans)
        self._launch = {}  # correlation -> (ts, tid)
        for e in events:
            if e.get("cat") in RUNTIME_CATS:
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    self._launch[c] = (float(e["ts"]), e.get("tid"))
        self._host = [e for e in events
                      if e.get("cat") in ("cpu_op", "user_annotation")]

    # -- device time by kernel name -------------------------------------
    def by_name(self) -> list[tuple[str, float]]:
        acc: dict[str, float] = {}
        for e in self.device:
            acc[e["name"]] = acc.get(e["name"], 0.0) + float(e["dur"]) / 1e6
        return sorted(acc.items(), key=lambda kv: -kv[1])

    def seconds_of(self, pred) -> float:
        return sum(float(e["dur"]) for e in self.kernels
                   if pred(e["name"])) / 1e6

    # -- scopes ---------------------------------------------------------
    def scopes(self, name: str) -> list[dict]:
        """The harness's ``bench.<name>[n]`` spans: {t0, t1, tid, n}."""
        head = f"bench.{name}["
        out = []
        for e in self._host:
            if e["cat"] == "user_annotation" and e["name"].startswith(head):
                t0 = float(e["ts"])
                out.append({"t0": t0, "t1": t0 + float(e["dur"]),
                            "tid": e.get("tid"),
                            "n": int(e["name"][len(head):-1])})
        out.sort(key=lambda s: s["t0"])
        return out

    def kernels_in(self, scopes: list[dict], pred, thread: str = "any"):
        """(device seconds, scopes that launched one) of the kernels whose
        name passes ``pred`` and whose launch lies inside a scope; ``thread``
        'same' keeps launches from the scope's own thread, 'other' those
        from other threads (autograd's backward), 'any' both."""
        starts = [s["t0"] for s in scopes]
        total, hit = 0.0, set()
        for e in self.kernels:
            if not pred(e["name"]):
                continue
            c = (e.get("args") or {}).get("correlation")
            if c not in self._launch:
                continue
            ts, tid = self._launch[c]
            i = bisect.bisect_right(starts, ts) - 1
            if i < 0 or ts > scopes[i]["t1"]:
                continue
            same = tid == scopes[i]["tid"]
            if thread == "same" and not same or thread == "other" and same:
                continue
            total += float(e["dur"])
            hit.add(i)
        return total / 1e6, [scopes[i] for i in sorted(hit)]

    # -- idle gaps --------------------------------------------------------
    def idle_gaps(self, tid, top: int = 10) -> list[tuple[str, float]]:
        """Device idle time between busy intervals, summed by what thread
        ``tid`` was doing at each gap's middle: its innermost harness span
        and, inside it, its innermost operator."""
        def index(cat, keep):
            rows = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                           e["name"]) for e in self._host
                          if e.get("tid") == tid and e["cat"] == cat
                          and keep(e["name"]))
            longest = max((b - a for a, b, _ in rows), default=0.0)
            return rows, [r[0] for r in rows], longest

        def innermost(table, t):
            rows, starts, longest = table
            i = bisect.bisect_right(starts, t) - 1
            while i >= 0 and rows[i][0] >= t - longest:
                if rows[i][1] >= t:
                    return rows[i][2]
                i -= 1
            return None

        spans = index("user_annotation", lambda n: n.startswith("bench."))
        ops = index("cpu_op", lambda n: True)
        acc: dict[str, float] = {}
        for (_, a), (b, _) in zip(self._busy, self._busy[1:]):
            mid = (a + b) / 2
            span = innermost(spans, mid)
            op = innermost(ops, mid)
            label = (f"{span.split('[')[0] if span else 'host'} / "
                     f"{op or 'python'}")
            acc[label] = acc.get(label, 0.0) + (b - a) / 1e6
        return sorted(acc.items(), key=lambda kv: -kv[1])[:top]


class Window:
    """The measured window's clock, and the part of it after the profiler
    stopped (its untraced tail), which the rates of a traced run are read
    from: tracing slows the host's side of each step. Each lap also notes
    where the host's time went (``LapNotes``)."""

    def __init__(self, run, prof, trace_s: float):
        self.run, self.prof, self.trace_s = run, prof, trace_s
        self.t0 = time.perf_counter()
        self._tail = None  # (start, images, reader seconds) at the stop
        self.laps: list[float] = []
        self.notes = LapNotes(run.spans)

    def lap(self, images: int) -> float:
        """Seconds since the window opened, after a whole epoch or pass;
        stops the profiler once ``trace_s`` have passed."""
        now = time.perf_counter()
        self.laps.append(now - self.t0)
        self.notes.lap()
        if self.prof is not None and self._tail is None and (
                now - self.t0 >= self.trace_s):
            self.prof.stop()
            self._tail = (time.perf_counter(), images,
                          self.run.spans.seconds.get("read", 0.0))
        return now - self.t0

    def close(self, images: int) -> None:
        dev = self.run.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        end = time.perf_counter()
        run = self.run
        run.window_s = end - self.t0
        read = run.spans.seconds.get("read", 0.0)
        if self.prof is not None and self._tail is None:
            self.prof.stop()
        self.notes.close()
        start, i0, r0 = self._tail or (self.t0, 0, 0.0)
        if end - start <= 0 or images == i0:
            start, i0, r0 = self.t0, 0, 0.0
        run.tail = {"seconds": end - start, "images": images - i0,
                    "read_s": read - r0}
        run.counts["laps"] = self.laps
        run.counts["lap_notes"] = self.notes.table


def _steal_s() -> float:
    """The machine's steal time so far (all CPUs): what the hypervisor gave
    to others while this guest wanted to run; 0 where /proc has none."""
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        return int(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


class LapNotes:
    """Per lap: this process's CPU seconds (all threads), the machine's
    steal seconds, the seconds spent in Python's garbage collector, the
    major page faults, and the host seconds of each harness span. They
    tell a slower lap's cause: more CPU for the same work, a host that
    gave the CPU away, the collector, the disk, or one part of the loop."""

    def __init__(self, spans: Spans):
        import gc

        self._spans = spans
        self.gc_s = 0.0
        self._gc_t = None
        gc.callbacks.append(self._gc)
        self.table: dict[str, list[float]] = {}
        self._last = self._now()

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            self.gc_s += time.perf_counter() - self._gc_t
            self._gc_t = None

    def _now(self) -> dict[str, float]:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        now = {"cpu_s": ru.ru_utime + ru.ru_stime, "steal_s": _steal_s(),
               "gc_s": self.gc_s, "majflt": float(ru.ru_majflt)}
        with self._spans._lock:
            now.update({f"{k.split('[')[0]}_s": v
                        for k, v in self._spans.seconds.items()})
        return now

    def lap(self) -> None:
        now = self._now()
        for k, v in now.items():
            self.table.setdefault(k, []).append(
                round(v - self._last.get(k, 0.0), 4))
        self._last = now

    def close(self) -> None:
        import gc

        if self._gc in gc.callbacks:
            gc.callbacks.remove(self._gc)
