"""Summarize a ``--trace`` capture: device busy and idle time, top ops.

Counterpart of ``eov_tpu/tools/profile_summary.py``, over the Chrome trace
that ``utils/trace.py`` writes (``--trace DIR`` on any CLI command,
``EOV_BENCH_TRACE`` / ``EOV_TRAIN_TRACE`` for the benches):

    python -m eov_tpu_torch.tools.profile_summary DIR [--top 20]

``summarize`` returns the reference's rows: a head row
``{device_busy_us, device_idle_us}``, then the top ops by self time, each
``{op, self_us, avg_us, occurrences, share_of_busy}``.

* A CUDA trace: the device events are the ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset`` events. Busy time is the union of their intervals; idle
  time is the span from the first device event's start to the last one's
  end, less busy time. An op's self time is the sum of its events'
  durations. A CUDA trace without a kernel event raises: it is never
  summarized as CPU work.
* A CPU trace (the head row says so, ``"source": "cpu_op"``): the
  ``cpu_op`` events; an op's self time is its duration less that of the
  ``cpu_op`` events nested in it on the same thread, busy time the union of
  the outermost ones, idle time their span less busy time (both 0, and
  no op rows, for a command that ran no PyTorch op).

The device comes from ``DIR/trace_meta.json``; without it, a trace that
records CUDA device properties or a kernel is a CUDA trace.

``idle_by_span`` reads the program's spans on the trace's clock (the
``eov.<span>`` annotations of ``utils/trace.py``): each device idle gap of
a CUDA trace (between the merged busy intervals) is put down to the
innermost ``eov.`` span open, at the gap's middle, on the thread that
launched the work ending the gap. ``main`` prints them after the top ops.
"""

from __future__ import annotations

import argparse
import bisect
import glob
import json
import os

__all__ = ["summarize", "idle_by_span", "load_trace", "main"]

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def load_trace(trace_dir: str) -> tuple[dict, str]:
    """(the Chrome trace document, its device type 'cuda' or 'cpu')."""
    meta_path = os.path.join(trace_dir, "trace_meta.json")
    meta = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        path = os.path.join(trace_dir, meta["trace"])
    else:
        files = glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json"),
                          recursive=True)
        if not files:
            raise SystemExit(f"no trace_meta.json or *.pt.trace.json under "
                             f"{trace_dir}")
        path = max(files, key=os.path.getmtime)
    with open(path) as f:
        doc = json.load(f)
    if meta is not None:
        device = meta["device"]
    else:
        device = "cuda" if doc.get("deviceProperties") or any(
            e.get("cat") == "kernel" for e in doc.get("traceEvents", ())
        ) else "cpu"
    return doc, device


def _complete(doc: dict, cats) -> list[dict]:
    return [e for e in doc.get("traceEvents", ())
            if e.get("ph") == "X" and e.get("cat") in cats and "dur" in e]


def _union_us(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _rows(ops: dict, busy: float, top: int) -> list[dict]:
    rows = [{"op": name, "self_us": s, "avg_us": s / n, "occurrences": n,
             "share_of_busy": s / busy if busy else 0.0}
            for name, (s, n) in ops.items()]
    rows.sort(key=lambda r: -r["self_us"])
    return rows[:top]


def _cuda_summary(doc: dict, top: int) -> list[dict]:
    events = _complete(doc, _DEVICE_CATS)
    if not any(e["cat"] == "kernel" for e in events):
        raise ValueError(
            "cuda trace holds no kernel events: the device activity was not "
            "recorded (CUPTI) or nothing ran on the card; it is not "
            "summarized as CPU work")
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events]
    busy = _union_us(spans)
    idle = max(b for _, b in spans) - min(a for a, _ in spans) - busy
    ops: dict[str, list] = {}
    for e in events:
        acc = ops.setdefault(e["name"], [0.0, 0])
        acc[0] += float(e["dur"])
        acc[1] += 1
    head = {"device_busy_us": busy, "device_idle_us": max(idle, 0.0),
            "device": "cuda", "source": "kernel+gpu_memcpy+gpu_memset"}
    return [head] + _rows(ops, busy, top)


def _cpu_summary(doc: dict, top: int) -> list[dict]:
    events = _complete(doc, ("cpu_op",))
    head = {"device_busy_us": 0.0, "device_idle_us": 0.0, "device": "cpu",
            "source": "cpu_op"}
    if not events:  # a command that ran no PyTorch op (e.g. store-info)
        return [head]
    ops: dict[str, list] = {}
    outer = []
    by_thread: dict[tuple, list] = {}
    for e in events:
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
        stack: list[list] = []  # [end, event, child time]
        for e in evs:
            a = float(e["ts"])
            b = a + float(e["dur"])
            while stack and stack[-1][0] <= a:
                _close(stack.pop(), ops)
            if stack:
                stack[-1][2] += float(e["dur"])
            else:
                outer.append((a, b))
            stack.append([b, e, 0.0])
        while stack:
            _close(stack.pop(), ops)
    busy = _union_us(outer)
    idle = max(b for _, b in outer) - min(a for a, _ in outer) - busy
    head.update(device_busy_us=busy, device_idle_us=max(idle, 0.0))
    return [head] + _rows(ops, busy, top)


def _close(frame: list, ops: dict) -> None:
    _, e, child = frame
    acc = ops.setdefault(e["name"], [0.0, 0])
    acc[0] += max(float(e["dur"]) - child, 0.0)
    acc[1] += 1


def _merged(intervals) -> list[list[float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_by_span(doc: dict, top: int = 20) -> list[dict]:
    """The device's idle gaps by the ``eov.`` span they fall in: rows
    ``{span, idle_us, gaps}``, most idle first (``span`` is ``outside``
    where no span was open). [] for a trace without device events."""
    device = sorted(_complete(doc, _DEVICE_CATS), key=lambda e: e["ts"])
    if not device:
        return []
    launch = {}  # correlation -> launching thread
    for e in _complete(doc, _RUNTIME_CATS):
        c = (e.get("args") or {}).get("correlation")
        if c is not None:
            launch[c] = e.get("tid")
    spans: dict = {}  # thread -> [(start, end, name)]
    for e in _complete(doc, ("user_annotation",)):
        if e["name"].startswith("eov."):
            t0 = float(e["ts"])
            spans.setdefault(e.get("tid"), []).append(
                (t0, t0 + float(e["dur"]), e["name"][4:]))
    busy = _merged((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in device)
    starts = [float(e["ts"]) for e in device]
    acc: dict[str, list] = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        nxt = device[bisect.bisect_left(starts, b)]
        tid = launch.get((nxt.get("args") or {}).get("correlation"))
        mid = (a + b) / 2
        inner = [s for s in spans.get(tid, ()) if s[0] <= mid <= s[1]]
        name = (min(inner, key=lambda s: s[1] - s[0])[2] if inner
                else "outside")
        row = acc.setdefault(name, [0.0, 0])
        row[0] += b - a
        row[1] += 1
    rows = [{"span": n, "idle_us": v[0], "gaps": v[1]}
            for n, v in acc.items()]
    rows.sort(key=lambda r: -r["idle_us"])
    return rows[:top]


def summarize(trace_dir: str, top: int = 20) -> list[dict]:
    """[head row, top ops by self time] of the trace under ``trace_dir``."""
    doc, device = load_trace(trace_dir)
    if device == "cuda":
        return _cuda_summary(doc, top)
    return _cpu_summary(doc, top)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    rows = summarize(args.trace_dir, args.top)
    head = rows[0]
    busy, idle = head["device_busy_us"], head["device_idle_us"]
    print(f"{head['device']} busy {busy / 1e3:.2f} ms, idle "
          f"{idle / 1e3:.2f} ms ({busy / (busy + idle + 1e-9) * 100:.1f}% "
          f"utilized; {head['source']})")
    for o in rows[1:]:
        # Long kernel names are template instantiations; keep the tail.
        name = o["op"]
        if len(name) > 90:
            name = "…" + name[-89:]
        print(f"{o['share_of_busy'] * 100:5.1f}%  {o['self_us']:>10.1f} us  "
              f"x{o['occurrences']:<5d} {name}")
    if head["device"] != "cuda":
        print("idle by eov span: none (a cpu trace has no device gaps)")
        return 0
    doc, _ = load_trace(args.trace_dir)
    gaps = idle_by_span(doc, args.top)
    print(f"idle by eov span ({len(gaps)} spans; each gap at its middle, "
          "on the launching thread):")
    for g in gaps:
        print(f"{g['idle_us'] / (idle + 1e-9) * 100:5.1f}%  "
              f"{g['idle_us']:>10.1f} us  x{g['gaps']:<5d} {g['span']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
