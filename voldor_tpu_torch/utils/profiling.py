"""Stage timers and device tracing (port of ``voldor_tpu/utils/profiling.py``).

The reference times its stages with tic/toc wall timers
(voldor/voldor.h:66-81, slam_py/voldor_slam.py:26-29). ``StageTimer`` is
the structured equivalent: per-stage totals and counts, with an optional
sync callable run before the clock is read (``lambda:
torch.cuda.synchronize(device)`` waits for the card, so a stage's time
includes its device work). ``device_trace`` records a ``torch.profiler``
trace of the enclosed calls and writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class StageTimer:
    """Accumulating per-stage wall timers; no-ops when disabled."""

    def __init__(self, enabled: bool = True, sync=None):
        self.enabled = enabled
        self._sync = sync  # run before reading the clock (torch.cuda.synchronize)
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        if self._sync is not None:
            self._sync()
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            lines.append(
                f"{name:>28}: {self.totals[name] * 1000:9.1f} ms "
                f"(x{self.counts[name]}, "
                f"{self.totals[name] / max(self.counts[name], 1) * 1000:7.2f} ms avg)"
            )
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the enclosed calls (the CPU, and
    the card where there is one) and write it to ``log_dir/trace.json``, a
    Chrome trace. Yields the profiler (``key_averages()`` reads its table)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")


_GLOBAL = {}


def tic(name: str = "default"):
    _GLOBAL[name] = time.perf_counter()


def toc(name: str = "default") -> float:
    return time.perf_counter() - _GLOBAL.get(name, time.perf_counter())
