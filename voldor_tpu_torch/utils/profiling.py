"""The program's tracer, and a Chrome-trace exporter.

The tracer times the stages of one call on the thread that makes it, and
counts the call's blocking reads of the device. ``open_record(root)``
starts a record on the calling thread (the SLAM layer opens one for each
``process_vo`` call while its metrics logger is open) with a root span;
``span(name)`` times a stage inside it; ``host_read(site, fn, x)`` returns
``fn(x)``, a read that waits for the device, and counts it and its wait
under ``site``; ``device_sync(site, device)`` does the same for the
statements it encloses, an op that waits for the device only where
``device`` is a CUDA device (a copy to the card from pageable host memory,
an op that checks its result on the host); ``count(name, n)`` adds n to a
counter; ``recording()`` says whether a record is open on the thread (a
count that needs a read of the device is made only then);
``close_record()`` ends the root span and returns the record's summary.

Spans never synchronise the device: they time the host, and the only
device waits recorded are those of the program's own reads. While a
``torch.profiler`` is recording, each span is also a ``voldor::<name>``
range of the profiler, so the spans lie on the trace's timeline beside the
device's intervals. The range is an operator's (``_RecordFunctionFast``),
not ``record_function``'s user annotation: the profiler mirrors a user
annotation onto the device's timeline as one interval from the first to
the last kernel launched inside it, which a reading of the device's busy
time would take for work. A record belongs to its thread: spans and reads
on another thread never enter it. With no record open on the thread,
``span``, ``host_read``, ``device_sync`` and ``count`` only test a
thread-local: they allocate nothing and enter no profiler range, and the
reads are made as without them, and nothing else.

``device_trace`` records a ``torch.profiler`` trace of the enclosed calls
and writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import threading
from time import perf_counter_ns

import torch

_NS = 1e-9


class _Local(threading.local):
    rec = None


_local = _Local()
_OFF = contextlib.nullcontext()
_range = torch._C._profiler._RecordFunctionFast


class _Sync:
    """The context manager that ``device_sync`` returns on a card."""

    __slots__ = ("rec", "site", "t0")

    def __init__(self, rec):
        self.rec, self.site, self.t0 = rec, None, 0

    def __enter__(self):
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec.read(self.site, perf_counter_ns() - self.t0)
        return False


class _Record:
    """One call's spans, reads and counts; also the context manager that
    ``span`` returns while the record is open."""

    __slots__ = ("spans", "stack", "pending", "reads", "counts", "sync")

    def __init__(self):
        self.spans = []  # [name, parent index, t0_ns, t1_ns, read wait ns]
        self.stack = []  # (index of an open span, its profiler range or None)
        self.pending = None
        self.reads = {}  # site -> [count, wait ns]
        self.counts = {}
        self.sync = _Sync(self)

    def __enter__(self):
        name, self.pending = self.pending, None
        rf = None
        if torch.autograd._profiler_enabled():
            rf = _range("voldor::" + name)
            rf.__enter__()
        parent = self.stack[-1][0] if self.stack else -1
        self.stack.append((len(self.spans), rf))
        self.spans.append([name, parent, perf_counter_ns(), 0, 0])
        return self

    def __exit__(self, *exc):
        t1 = perf_counter_ns()
        i, rf = self.stack.pop()
        self.spans[i][3] = t1
        if rf is not None:
            rf.__exit__(None, None, None)
        return False

    def read(self, site: str, wait_ns: int):
        r = self.reads.get(site)
        if r is None:
            self.reads[site] = [1, wait_ns]
        else:
            r[0] += 1
            r[1] += wait_ns
        if self.stack:
            self.spans[self.stack[-1][0]][4] += wait_ns


def open_record(root: str) -> None:
    """Start a record on this thread, with ``root`` as its outermost span
    (a record already open on the thread is dropped)."""
    rec = _Record()
    _local.rec = rec
    rec.pending = root
    rec.__enter__()


def close_record() -> dict | None:
    """End this thread's record, closing the spans still open, and return
    its summary (``_summarize``); None when no record is open."""
    rec = _local.rec
    if rec is None:
        return None
    _local.rec = None
    while rec.stack:
        rec.__exit__(None, None, None)
    return _summarize(rec)


def span(name: str):
    """A context manager that times the stage ``name`` in this thread's
    record; with no record open, one that does nothing."""
    rec = _local.rec
    if rec is None:
        return _OFF
    rec.pending = name
    return rec


def host_read(site: str, fn, x):
    """``fn(x)``: a read that waits for the device (``.item()``, ``bool()``,
    ``tolist()``, a copy to the host, an event's wait), counted with its
    wait under ``site`` in this thread's record."""
    rec = _local.rec
    if rec is None:
        return fn(x)
    t0 = perf_counter_ns()
    out = fn(x)
    rec.read(site, perf_counter_ns() - t0)
    return out


def device_sync(site: str, device):
    """A context manager around an op that waits for the device only where
    ``device`` is a CUDA device; there it counts the op under ``site`` in
    this thread's record, as ``host_read`` counts a read. Elsewhere, or with
    no record open, it does nothing."""
    rec = _local.rec
    if rec is None or torch.device(device).type != "cuda":
        return _OFF
    rec.sync.site = site
    return rec.sync


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (one event by default) to the counter ``name`` in this
    thread's record."""
    rec = _local.rec
    if rec is not None:
        rec.counts[name] = rec.counts.get(name, 0) + n


def recording() -> bool:
    """Whether a record is open on this thread."""
    return _local.rec is not None


def _summarize(rec: _Record) -> dict:
    """The record as the fields of one event: ``spans`` (name -> [total_s,
    self_s], summed over the name's spans; a span's self time is its
    duration less its child spans' and less the waits of the reads made
    directly in it), ``host_reads``, ``reads_by_site`` (site -> count),
    ``read_wait_s`` and ``counts``."""
    child_ns = [0] * len(rec.spans)
    for name, parent, t0, t1, _ in rec.spans:
        if parent >= 0:
            child_ns[parent] += t1 - t0
    spans = {}
    for (name, _, t0, t1, wait), child in zip(rec.spans, child_ns):
        tot = spans.setdefault(name, [0, 0])
        tot[0] += t1 - t0
        tot[1] += t1 - t0 - child - wait
    return dict(
        spans={k: [round(a * _NS, 6), round(b * _NS, 6)] for k, (a, b) in spans.items()},
        host_reads=sum(n for n, _ in rec.reads.values()),
        reads_by_site={k: n for k, (n, _) in rec.reads.items()},
        read_wait_s=round(sum(w for _, w in rec.reads.values()) * _NS, 6),
        counts=dict(rec.counts),
    )


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the enclosed calls (the CPU, and
    the card where there is one) and write it to ``log_dir/trace.json``, a
    Chrome trace. Yields the profiler (``key_averages()`` reads its table).
    The tracer's spans show in it as ``voldor::<name>`` ranges."""
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
