"""Spans around the calls into the program's layers, and the reduction of a
profiler trace to busy time, idle gaps and top device operations.

Spans are kept in memory. In a traced run each span synchronises the card
at both edges, so the host interval of a span holds the device work it
launched. Under the profiler each span is also a ``bench::<name>`` range,
which puts it on the trace's timeline beside the device intervals.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict


class Spans:
    """Wraps module attributes in timed spans; ``restore`` undoes it."""

    def __init__(self, torch, sync: bool):
        self.torch = torch
        self.sync = sync and torch.cuda.is_available()
        self.intervals = defaultdict(list)  # name -> [(t0, t1)] perf_counter seconds
        self.work = defaultdict(float)  # layer -> least seconds of its profiled calls
        self.profiling = False
        self._saved = []

    def _edge(self):
        if self.sync:
            self.torch.cuda.synchronize()

    def wrap(self, owner, attr: str, name: str, after=None):
        fn = getattr(owner, attr)
        record_function = self.torch.profiler.record_function

        def wrapper(*args, **kwargs):
            self._edge()
            t0 = time.perf_counter()
            with record_function(f"bench::{name}"):
                try:
                    out = fn(*args, **kwargs)
                finally:
                    self._edge()
            self.intervals[name].append((t0, time.perf_counter()))
            if after is not None and self.profiling:
                with record_function("bench::count"):
                    after(args, kwargs, out)
            return out

        setattr(owner, attr, wrapper)
        self._saved.append((owner, attr, fn))

    def total(self, *names, lo=None, hi=None) -> float:
        """Seconds spent in the named spans, clipped to [lo, hi]."""
        s = 0.0
        for name in names:
            for a, b in self.intervals.get(name, ()):
                a = a if lo is None else max(a, lo)
                b = b if hi is None else min(b, hi)
                s += max(0.0, b - a)
        return s

    def restore(self):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()


def _merge(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _overlap(merged, spans) -> float:
    """Length of the union of ``merged`` inside the union of ``spans``."""
    total = 0.0
    spans = _merge(spans)
    j = 0
    for s, e in spans:
        while j < len(merged) and merged[j][1] <= s:
            j += 1
        k = j
        while k < len(merged) and merged[k][0] < e:
            total += max(0.0, min(e, merged[k][1]) - max(s, merged[k][0]))
            k += 1
    return total


def _subtract(merged, cuts):
    """The parts of the sorted, disjoint ``merged`` outside the sorted,
    disjoint ``cuts``."""
    out, j = [], 0
    for s, e in merged:
        while j < len(cuts) and cuts[j][1] <= s:
            j += 1
        k = j
        while k < len(cuts) and cuts[k][0] < e:
            if cuts[k][0] > s:
                out.append([s, cuts[k][0]])
            s = max(s, cuts[k][1])
            k += 1
        if e > s:
            out.append([s, e])
    return out


def reduce_profile(torch, prof, stretch: str) -> dict:
    """Busy time of the device over the ``bench::<stretch>`` range, the
    busy time inside each other benchmark span, the longest idle gaps
    summed by the innermost benchmark span open during them, and the device
    operations that took the most time. Time spent counting work
    (``bench::count``) is taken out of the stretch. Seconds."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, spans, ops = [], defaultdict(list), defaultdict(float)
    # the raw trace events: no operator tree is built, so the host's memory
    # stays near the trace's own size
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s, t = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if name.startswith("bench::"):
            if e.device_type() != cuda:
                spans[name[7:]].append((s, t))
        elif e.device_type() == cuda and t > s:
            dev.append((s, t))
            ops[name[:160]] += t - s
    if not spans.get(stretch) or not dev:
        return {}
    lo = min(s for s, _ in spans[stretch])
    hi = max(t for _, t in spans[stretch])
    merged = [[max(s, lo), min(t, hi)] for s, t in _merge(dev) if t > lo and s < hi]
    counting = _merge([(max(s, lo), min(t, hi)) for s, t in spans.get("count", ()) if t > lo and s < hi])
    count_s = sum(t - s for s, t in counting)
    working = _subtract(merged, counting)  # the device's busy intervals, counting taken out
    busy = sum(t - s for s, t in working)
    busy_in = {name: _overlap(working, iv) for name, iv in spans.items()
               if name not in (stretch, "count")}
    # idle gaps, each labelled by the shortest benchmark span that holds
    # its midpoint (longer spans are assigned first, shorter ones overwrite)
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gap_iv = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
    mids = [0.5 * (a + b) for a, b in gap_iv]
    label = ["outside_layer_spans"] * len(gap_iv)
    for _, s, t, name in sorted(((t - s, s, t, name) for name, iv in spans.items()
                                 if name not in (stretch, "count") for s, t in iv), reverse=True):
        for i in range(bisect.bisect_left(mids, s), bisect.bisect_right(mids, t)):
            label[i] = name
    c_lo = [s for s, _ in counting]
    gaps = defaultdict(float)
    for (a, b), name in zip(gap_iv, label):
        inside = 0.0
        for j in range(max(0, bisect.bisect_right(c_lo, a) - 1), bisect.bisect_left(c_lo, b)):
            inside += max(0.0, min(b, counting[j][1]) - max(a, counting[j][0]))
        gaps[name] += (b - a) - inside
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy, window_s=(hi - lo) - count_s, busy_in=busy_in,
                device_ops=[[k, v] for k, v in top],
                idle_gaps=[[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]])


def profile_stretch(torch, device: str, spans: Spans, work) -> dict:
    """Runs ``work()`` as the profiled stretch, counting each layer call's
    least work, and reduces the trace. On the CPU there is no device to
    trace: the work is counted and nothing else is read."""
    spans.profiling = True
    try:
        if device == "cpu":
            work()
            return {"work": dict(spans.work)}
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("bench::stretch"):
                work()
                torch.cuda.synchronize()
    finally:
        spans.profiling = False
    out = reduce_profile(torch, prof, "stretch")
    out["work"] = dict(spans.work)
    return out
