"""Structured run metrics: a jsonl sink.

Counterpart of ``eov_tpu/utils/metrics.py``: one JSON object per event
(resolved config, per-batch times, final accuracy, each epoch's or pass's
``utils.trace`` report) appended to a ``metrics.jsonl`` so runs are
machine-comparable. Times come from ``utils/trace.py``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import IO, Any

__all__ = ["MetricsWriter"]


class MetricsWriter:
    """Append-only jsonl event sink; no-op when path is None. Safe to share
    between the extraction loop and its decode thread."""

    def __init__(self, path: str | None):
        self._f: IO[str] | None = None
        self._lock = threading.Lock()
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")

    def write(self, event: str, **fields: Any) -> None:
        if self._f is None:
            return
        line = json.dumps({"event": event, "time": time.time(), **fields})
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
