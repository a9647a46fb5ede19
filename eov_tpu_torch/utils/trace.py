"""The port's tracing: spans, counters, device gaps, and ``--trace DIR``.

Always on, with no switch; one registry per process.

* ``span(name, device=False)`` marks a stretch of host code. It records
  its name, its parent, its thread, its ``perf_counter`` start and end,
  and the id of the step it belongs to. Its self time is its duration
  less the time its children cover. ``device=True`` marks a span that
  launches device work. While a profiler is active (the plain flag
  ``torch.autograd.profiler._is_profiler_enabled``), each span also enters
  ``record_function("eov.<name>")``. That puts the program's spans on the
  device trace's clock.
* ``root(name, number, device)`` is the span of one epoch or pass
  (``train.epoch``, ``extract.pass``). Spans opened inside it fold into
  its summary: seconds, self seconds and count per name. Spans on other
  threads fold into it too, such as the decode thread's. ``step()``
  advances its step id. When it closes, its summary becomes a report,
  kept in a list of the most recent ``MAX_REPORTS`` (``reports()``).
* ``count(name, n=1)`` adds to a named counter (``counters()``). A report
  holds each counter's increment over its root.
* ``span(name, device=True, timed=True)`` also times the device work
  between its ends: a timing event on the root's stream at its start and at
  its end, from any thread (autograd's backward included). A report's
  ``device_span_s`` sums those seconds by name (``None`` on the CPU).

Device gaps. On a CUDA device, the root's thread is in host-only state
when its innermost open span has ``device=False``; code outside every
span is host-only too. At each change of that state a timing
``torch.cuda.Event`` is recorded on the root's stream (from a pool kept per
stream); a return from a device span is recorded at the next span
boundary, so device spans in a row cost none. Between entering host-only
work (event ``c``) and leaving it (event ``o``) the thread launched
nothing, so ``c.elapsed_time(o)`` is the time the device sat idle on that
stream. The idle ended when the host
reached ``o``, so it covers host time ``[T_o - g, T_o]``. It is put down to
the innermost host-only spans over that interval, in proportion to their
overlap, and only its part inside the root counts. The events are read
when the root closes (each epoch ends on ``float()`` of its metrics, each
pass on its last ``.cpu()``, so nothing waits), or earlier once they have
completed. The gaps are a lower bound on idle: idle inside a device span
is not counted, nor the host time between a device span's end and the
next boundary, nor idle of other streams (NCCL's). On the CPU they are
``None``. A root whose block raises reads none.

``trace(dir, device)`` profiles a block with ``torch.profiler`` (CPU, plus
CUDA on a ``cuda`` device) and writes under ``dir``:

* ``<host>_<pid>.<ms>.pt.trace.json``: the Chrome trace
  (``chrome://tracing``, Perfetto), which holds the ``eov.*`` spans;
* ``trace_meta.json``: ``{"device", "device_name", "trace",
  "activities"}``, which says what device the trace is of and which file
  holds it.

``tools/profile_summary.py DIR`` reads both. A CUDA request without a GPU
raises before anything is profiled.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import socket
import threading
import time
from typing import Callable

import torch
import torch.autograd.profiler as _profiler

from eov_tpu_torch.utils.device import resolve_device

__all__ = ["trace", "META", "span", "root", "step", "count", "counter",
           "counters", "reports", "attribute", "set_event_clock",
           "MAX_REPORTS"]

META = "trace_meta.json"
MAX_REPORTS = 256
_RESOLVE_AT = 64  # gaps in flight before the completed ones are read

_perf = time.perf_counter
_lock = threading.Lock()
_reports: collections.deque = collections.deque(maxlen=MAX_REPORTS)
_roots: list = []          # open roots, innermost last, every thread
_threads: list = []        # the live threads' state (their counters)
_retired: dict[str, float] = {}  # the counters of threads that ended
_local = threading.local()


class _Base:
    """The bottom of every thread's stack: outside every span. ``_root``
    is the innermost open root of any thread, which a thread's outermost
    spans fold into."""
    name, device, _root, _child = "host", False, None, 0.0


class _Thread:
    """One thread's open spans, its counters (only it writes them), and
    the gap account of the root open on it, if any."""

    __slots__ = ("stack", "counts", "thread", "stamp")

    def __init__(self):
        self.stack: list = [_Base()]
        self.counts: dict[str, float] = {}
        self.thread = threading.current_thread()
        self.stamp = None


def _thread() -> _Thread:
    try:
        return _local.th
    except AttributeError:
        th = _local.th = _Thread()
        with _lock:
            _threads.append(th)
        return th


# -- counters ---------------------------------------------------------------

def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    try:
        c = _local.th.counts
    except AttributeError:
        c = _thread().counts
    c[name] = c.get(name, 0) + n


def counters() -> dict[str, float]:
    """Every counter's value so far, all threads."""
    with _lock:
        for th in [th for th in _threads if not th.thread.is_alive()]:
            _threads.remove(th)
            for k, v in th.counts.items():
                _retired[k] = _retired.get(k, 0) + v
        parts = [dict(_retired)] + [dict(th.counts) for th in _threads]
    out: dict[str, float] = {}
    for part in parts:
        for k, v in part.items():
            out[k] = out.get(k, 0) + v
    return out


def counter(name: str) -> float:
    """The counter's value so far (0 if never counted)."""
    return counters().get(name, 0)


def reports() -> list[dict]:
    """The reports of the most recent roots, oldest first."""
    with _lock:
        return list(_reports)


# -- the device clock -------------------------------------------------------

class _CudaClock:
    """Timing events on one stream, from a pool that outlives the roots
    (an event made and destroyed each time costs as much as recording
    it)."""

    def __init__(self, stream):
        self.stream = stream
        self._pool: list = []

    def record(self):
        try:
            ev = self._pool.pop()
        except IndexError:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def done(self, ev) -> bool:
        return ev.query()

    def wait(self, ev) -> None:
        ev.synchronize()

    def read(self, pairs: list) -> list[float]:
        """The seconds between each completed pair (c, o); the events go
        back to the pool."""
        out = [c.elapsed_time(o) * 1e-3 for c, o in pairs]
        for pair in pairs:
            self._pool.extend(pair)
        return out


_clocks: dict = {}  # (device index, stream) -> its clock


def _cuda_clock(device: torch.device):
    if device.type != "cuda":
        return None
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    clock = _clocks.get(key)
    if clock is None:
        with _lock:
            clock = _clocks.setdefault(key, _CudaClock(stream))
    return clock


_clock_for: Callable = _cuda_clock


def set_event_clock(factory: Callable | None) -> None:
    """``factory(device)`` -> the clock a root on ``device`` stamps with, or
    None for no gaps; None restores the CUDA events. A clock has
    ``record()``, ``done(ev)``, ``wait(ev)`` and ``read(pairs)``, as
    ``_CudaClock``; tests inject one."""
    global _clock_for
    _clock_for = factory or _cuda_clock


def attribute(gap: float, t_c: float, t_o: float, timeline: list,
              lo: float, out: dict) -> float:
    """Put a device gap of ``gap`` seconds, which ended at host time
    ``t_o`` inside the host-only interval that began at ``t_c``, down to
    the labels of ``timeline`` (``[(t, label), ...]``: from ``t`` on the
    innermost host-only span was ``label``), in proportion to their
    overlap with ``[t_o - gap, t_o]``; nothing before ``lo`` (the root's
    start) or ``t_c`` counts. Adds to ``out``; returns the seconds put
    down."""
    a = max(t_o - gap, t_c, lo)
    if a >= t_o:
        return 0.0
    total, e = 0.0, t_o
    for s, label in reversed(timeline):  # the gap is the stretch's tail
        ov = e - max(s, a)
        if ov > 0:
            out[label] = out.get(label, 0.0) + ov
            total += ov
        if s <= a:
            break
        e = s
    return total


HOST, DEVICE, LAZY = 0, 1, 2  # a root thread's state: see _Stamp


class _Stamp:
    """The host-only / device state of a root's thread, and its gaps.

    ``state`` is ``HOST`` (a host-only stretch is open, since event ``c``),
    ``DEVICE``, or ``LAZY``: back from a device span, not yet stamped. The
    stretch then opens at the next span boundary, so device spans that
    follow one another directly cost no event; the host time before that
    boundary is not counted (the gaps stay a lower bound)."""

    def __init__(self, clock, t0: float, label: str):
        self.clock, self.t0 = clock, t0
        self.pending: list = []   # (c, o, t_c, t_o, timeline)
        self.timed: list = []     # (name, start, end) of timed spans
        self.n = 0                # host-only stretches timed
        self.gap_s = 0.0
        self.by_span: dict[str, float] = {}
        self.to_host(t0, label)

    def to_host(self, now: float, label: str) -> None:
        """A host-only stretch opens under ``label``."""
        self.state = HOST
        self.c, self.t_c, self.timeline = self.clock.record(), now, [
            (now, label)]

    def to_device(self, now: float) -> None:
        """The open host-only stretch closes: device work may follow."""
        self.state = DEVICE
        self.pending.append((self.c, self.clock.record(), self.t_c, now,
                             self.timeline))
        self.timeline = None
        if len(self.pending) >= _RESOLVE_AT:
            self.resolve(wait=False)

    def resolve(self, wait: bool) -> None:
        """Read the gaps in flight once the newest has completed (the
        events are on one stream, so the others have too); with ``wait``,
        wait for it."""
        if not self.pending:
            return
        clock, last = self.clock, self.pending[-1][1]
        if not clock.done(last):
            if not wait:
                return
            clock.wait(last)
        pending, self.pending = self.pending, []
        gaps = clock.read([(p[0], p[1]) for p in pending])
        for gap, (_, _, t_c, t_o, timeline) in zip(gaps, pending):
            if gap > 0:
                self.gap_s += attribute(gap, t_c, t_o, timeline, self.t0,
                                        self.by_span)
        self.n += len(pending)

    def close(self, now: float) -> None:
        if self.state == HOST:
            self.to_device(now)
        self.resolve(wait=True)

    def timed_seconds(self) -> dict[str, float]:
        """The timed spans' device seconds by name (waits for the last)."""
        with _lock:
            timed, self.timed = self.timed, []
        out: dict[str, float] = {}
        if timed:
            self.clock.wait(timed[-1][2])
            for (name, _, _), s in zip(timed, self.clock.read(
                    [(a, b) for _, a, b in timed])):
                out[name] = out.get(name, 0.0) + s
        return out


# -- spans ------------------------------------------------------------------

class span:
    """``with span(name, device=False) as s:``; ``s`` keeps ``name``,
    ``parent`` (the enclosing span on this thread, or None), ``thread``
    (its ident), ``t0``, ``t1`` (``perf_counter`` seconds) and ``step``
    (``(root number, step)`` of the root it folds into, or None)."""

    __slots__ = ("name", "device", "timed", "t0", "t1", "_step", "_parent",
                 "_child", "_rf", "_root", "_th", "_ev")

    def __init__(self, name: str, device: bool = False, timed: bool = False):
        self.name = name
        self.device = device
        self.timed = timed

    @property
    def parent(self):
        p = self._parent
        return None if isinstance(p, _Base) else p

    @property
    def thread(self) -> int:
        return self._th.thread.ident

    @property
    def step(self):
        rt = self._root
        return None if rt is None else (rt.number, self._step)

    def _profile(self, rt) -> None:
        self._rf = _profiler.record_function("eov." + self.name)
        self._rf.__enter__()
        if rt is not None:
            rt.profiled = True

    def __enter__(self):
        try:
            th = _local.th
        except AttributeError:
            th = _thread()
        stack = th.stack
        parent = stack[-1]
        self._parent = parent
        self._th = th
        self._child = 0.0
        rt = self._root = parent._root
        if _profiler._is_profiler_enabled:
            self._profile(rt)
        else:
            self._rf = None
        stack.append(self)
        self._ev = None
        if self.timed and rt is not None and rt.stamp is not None:
            self._ev = rt.stamp.clock.record()
        self.t0 = now = _perf()
        if rt is not None:
            self._step = rt.step_id
            st = th.stamp
            if st is not None:
                if self.device:
                    if st.state == HOST:
                        st.to_device(now)
                    else:  # one device span after another: no event
                        st.state = DEVICE
                elif st.state == HOST:
                    st.timeline.append((now, self.name))
                else:
                    st.to_host(now, self.name)
        return self

    def __exit__(self, et, ev, tb):
        self.t1 = now = _perf()
        th = self._th
        th.stack.pop()
        dur = now - self.t0
        parent = self._parent
        parent._child += dur
        rt = self._root
        if self._ev is not None and rt.stamp is not None:
            st = rt.stamp
            with _lock:
                st.timed.append((self.name, self._ev, st.clock.record()))
        if rt is not None:
            if rt._th is th:
                try:
                    a = rt._agg[self.name]
                    a[0] += dur
                    a[1] += dur - self._child
                    a[2] += 1
                except KeyError:
                    rt._agg[self.name] = [dur, dur - self._child, 1]
                st = th.stamp
                if st is not None:
                    if parent.device:
                        if st.state == HOST:
                            st.to_device(now)
                        else:
                            st.state = DEVICE
                    elif st.state == HOST:
                        st.timeline.append((now, parent.name))
                    elif st.state == DEVICE:
                        st.state = LAZY  # stamped at the next boundary
                    else:
                        st.to_host(now, parent.name)
            else:
                rt.fold_other(self.name, dur, dur - self._child)
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        return False


class root(span):
    """The span of one epoch or pass, whose summary becomes a report:
    ``with root("train.epoch", epoch, device) as r:``; ``r.report`` once
    it has closed. ``kind`` is the name's first word; without ``number``
    the roots of one name are numbered in order."""

    __slots__ = ("number", "kind", "step_id", "stamp", "profiled", "report",
                 "_dev", "_agg", "_other", "_c0", "_last", "_outer")

    _passes: dict[str, int] = {}

    def __init__(self, name: str, number: int | None = None,
                 device: torch.device | str | None = None):
        super().__init__(name, False)
        self.kind = name.split(".")[0]
        if number is None:
            with _lock:
                number = root._passes.get(name, 0)
                root._passes[name] = number + 1
        self.number = number
        self._dev = torch.device(device) if device is not None else None
        self.report = None

    def __enter__(self):
        th = self._th = _thread()
        self._parent, self._root, self._child = th.stack[-1], self, 0.0
        self.step_id = self._step = 0
        self.profiled = bool(_profiler._is_profiler_enabled)
        self._rf = None
        if self.profiled:
            self._profile(None)
        self._agg: dict[str, list] = {}    # spans of its own thread
        self._other: dict[str, list] = {}  # of other threads, under _lock
        self._c0 = counters()
        with _lock:
            _roots.append(self)
            _Base._root = self
        th.stack.append(self)
        self.t0 = self._last = _perf()
        clock = _clock_for(self._dev) if self._dev is not None else None
        self.stamp = (_Stamp(clock, self.t0, self.name) if clock is not None
                      else None)
        self._outer, th.stamp = th.stamp, self.stamp
        return self

    def fold_other(self, name: str, dur: float, self_s: float) -> None:
        with _lock:
            a = self._other.setdefault(name, [0.0, 0.0, 0])
            a[0] += dur
            a[1] += self_s
            a[2] += 1

    def __exit__(self, et, ev, tb):
        self.t1 = now = _perf()
        th = self._th
        th.stack.pop()
        th.stamp = self._outer
        dur = now - self.t0
        self._parent._child += dur
        a = self._agg.setdefault(self.name, [0.0, 0.0, 0])
        a[0] += dur
        a[1] += dur - self._child
        a[2] += 1
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        if _profiler._is_profiler_enabled:
            self.profiled = True
        gap = by = n_gaps = timed = None
        st, self.stamp = self.stamp, None
        if st is not None and et is None:  # a raising block reads none
            st.close(now)
            gap, by, n_gaps = st.gap_s, dict(st.by_span), st.n
            timed = st.timed_seconds()
        c1 = counters()
        with _lock:
            _roots.remove(self)
            _Base._root = _roots[-1] if _roots else None
            agg = {n: list(a) for n, a in self._agg.items()}
            for n, a in self._other.items():
                b = agg.setdefault(n, [0.0, 0.0, 0])
                for i in range(3):
                    b[i] += a[i]
        self.report = {
            "kind": self.kind, "name": self.name, "epoch": self.number,
            "wall_s": dur, "profiled": self.profiled,
            "steps": self.step_id,
            "spans": {n: {"s": a[0], "self_s": a[1], "n": a[2]}
                      for n, a in agg.items()},
            "counters": {k: v - self._c0.get(k, 0) for k, v in c1.items()
                         if v != self._c0.get(k, 0)},
            "device_gap_s": gap, "device_gap_by_span": by,
            "device_gap_n": n_gaps, "device_span_s": timed}
        with _lock:
            _reports.append(self.report)
        return False


def step() -> float:
    """Advance the current root's step id; returns the seconds since the
    previous step (or the root's start); 0 outside every root."""
    rt = _thread().stack[-1]._root
    if rt is None:
        return 0.0
    now = _perf()
    dt, rt._last = now - rt._last, now
    rt.step_id += 1
    return dt


# -- the profiler capture ---------------------------------------------------

@contextlib.contextmanager
def trace(trace_dir: str, device: torch.device | str = "cuda"):
    """Profile the block; write the trace and its meta file on exit."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize(dev)
    name = (f"{socket.gethostname()}_{os.getpid()}."
            f"{int(time.time() * 1000)}.pt.trace.json")
    prof.export_chrome_trace(os.path.join(trace_dir, name))
    meta = {"device": dev.type,
            "device_name": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
            "trace": name,
            "activities": [a.name for a in activities]}
    with open(os.path.join(trace_dir, META), "w") as f:
        json.dump(meta, f)
