"""Per-window structured metrics (JSON lines; a copy of
``voldor_tpu/utils/metrics.py``).

The reference's observability is unstructured stdout prints
(voldor/config.h:31 --silent gating; slam prints). For long KITTI-scale
runs this logger gives a machine-readable event stream a run can be
debugged from: one JSON object per line with a monotonic timestamp —
VO window outcomes (fps, densities, truncation), keyframe events, mapping
link gate decisions, and PGO solves.

Disabled by default (zero overhead): enable with
``slam.metrics.open(path)`` or the demo's ``--metrics`` flag.
"""

from __future__ import annotations

import json
import threading
import time


class MetricsLogger:
    def __init__(self, path: str | None = None):
        self._fh = None
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        if path:
            self.open(path)

    @property
    def enabled(self) -> bool:
        return self._fh is not None

    def open(self, path: str) -> "MetricsLogger":
        self._fh = open(path, "a", buffering=1)
        self._t0 = time.perf_counter()
        return self

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def log(self, event: str, **fields) -> None:
        """Append one JSON line; no-op when disabled."""
        if self._fh is None:
            return
        rec = {"t": round(time.perf_counter() - self._t0, 4), "event": event}
        for k, v in fields.items():
            if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
                v = v.item()
            elif hasattr(v, "tolist"):
                v = v.tolist()
            rec[k] = v
        with self._lock:
            self._fh.write(json.dumps(rec) + "\n")
