"""The port's tracer (voldor_tpu_torch/utils/profiling.py) and what it
records of a VO call, on the CPU.

* The tracer alone: nothing recorded and no profiler range entered with no
  record open; nesting, self time, read waits and counts; a second
  thread's spans stay out of the first thread's record.
* A tiny stereo stream through VOLDOR_SLAM with the metrics logger open:
  every ``vo_window`` event carries the record's fields, children's totals
  fit in their parents', ``vo.call`` agrees with ``window_s``, and
  ``host_reads`` equals an independent count of the host reads made while
  the call's record was open (Tensor's reading methods patched).
* The same stream with the logger closed: poses and keyframe depths
  bitwise equal.
* Under torch.profiler: the ``voldor::`` ranges are operator ranges, not
  user annotations, and nest as the spans; the depth round's aten ops fall
  inside ``voldor::depth.round``.
* The benchmark's four readers of these fields, on a hand-made record.
"""

import importlib.util
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from voldor_tpu_torch.ops import lie
from voldor_tpu_torch.slam.system import VOLDOR_SLAM
from voldor_tpu_torch.utils import profiling
from voldor_tpu_torch.vo import engine

from synthetic import plane_depth, render_window

ROOT = Path(__file__).resolve().parents[1]

# --------------------------------------------------------------------------
# (a) the tracer alone
# --------------------------------------------------------------------------


def _sleep_read(x):
    time.sleep(0.002)
    return x


def test_no_record_records_nothing_and_enters_no_range(monkeypatch):
    entered = []
    real = profiling._range

    def counting(*a, **k):
        entered.append(a)
        return real(*a, **k)

    monkeypatch.setattr(profiling, "_range", counting)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with profiling.span("vo.call"):
                assert profiling.host_read("site", int, torch.tensor(3)) == 3
                profiling.count("c")
    assert not entered
    assert not any(e.name.startswith("voldor::") for e in prof.events())
    assert profiling.close_record() is None
    assert profiling.span("x") is profiling.span("y")  # one shared no-op


def test_nesting_self_time_reads_and_counts():
    profiling.open_record("root")
    time.sleep(0.002)
    with profiling.span("a"):
        time.sleep(0.002)
        assert profiling.host_read("wait.a", _sleep_read, 7) == 7
        with profiling.span("b"):
            time.sleep(0.003)
            profiling.host_read("wait.b", _sleep_read, 0)
            profiling.host_read("wait.b", _sleep_read, 0)
        profiling.count("n")
        profiling.count("n")
    with profiling.span("c"):
        pass
    rec = profiling.close_record()
    assert profiling.close_record() is None
    sp = rec["spans"]
    assert set(sp) == {"root", "a", "b", "c"}
    assert rec["host_reads"] == 3 and rec["reads_by_site"] == {"wait.a": 1, "wait.b": 2}
    assert rec["counts"] == {"n": 2}
    assert rec["read_wait_s"] >= 0.006
    (root, root_self), (a, a_self), (b, b_self) = sp["root"], sp["a"], sp["b"]
    assert root > a > b > 0.007
    # self time: the duration less the children's and less the reads' waits
    assert root_self == pytest.approx(root - a - sp["c"][0], abs=3e-6)
    assert 0.002 <= root_self and 0.002 <= a_self < a - b - 0.002
    assert 0.003 <= b_self < b - 0.004
    # every instant of the root is some span's self time or a read's wait
    selfs = sum(v[1] for v in sp.values())
    assert selfs + rec["read_wait_s"] == pytest.approx(root, abs=1e-5)


def test_a_second_thread_stays_out_of_the_record():
    profiling.open_record("root")
    done = {}

    def other():
        with profiling.span("theirs"):
            profiling.host_read("theirs", int, torch.tensor(1))
        profiling.open_record("own")
        with profiling.span("inner"):
            pass
        done["own"] = profiling.close_record()

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    with profiling.span("mine"):
        pass
    rec = profiling.close_record()
    assert set(rec["spans"]) == {"root", "mine"} and rec["host_reads"] == 0
    assert set(done["own"]["spans"]) == {"own", "inner"}


# --------------------------------------------------------------------------
# (b)-(d) a tiny stereo stream through VOLDOR_SLAM
# --------------------------------------------------------------------------

H, W = 40, 56
FX = FY = 48.0
CX, CY = W / 2, H / 2
PLANES = [
    (np.array([0.1, 0.15, 1.0]) / np.linalg.norm([0.1, 0.15, 1.0]), 8.0),
    (np.array([-0.45, 0.1, 1.0]) / np.linalg.norm([-0.45, 0.1, 1.0]), 6.5),
    (np.array([0.3, -0.45, 1.0]) / np.linalg.norm([0.3, -0.45, 1.0]), 7.0),
]
N_FLOWS = 16
USER_CONFIG = "--n_poses_to_sample 512 --depth_rand_samples 4"
# the host reads of a tensor's values, as an independent count
READERS = ("item", "tolist", "__bool__", "__int__", "__float__", "__index__", "cpu", "numpy")
SPAN_PARENT = {
    "vo.inputs": "vo.call", "vo.dispatch": "vo.call", "vo.upload": "vo.call",
    "vo.collect": "vo.call", "engine.init": "vo.dispatch", "engine.solve": "vo.dispatch",
    "engine.covis": "vo.dispatch", "pose.sweep": "engine.solve", "depth.round": "engine.solve",
}


def _scene():
    rng = np.random.default_rng(5)
    poses = np.zeros((N_FLOWS, 6), np.float32)
    for f in range(N_FLOWS):
        poses[f, :3] = rng.normal(0, 0.008, 3)
        poses[f, 3:6] = [0.45 + 0.03 * rng.normal(), 0.03 * rng.normal(), 0.18]
    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)

    def r2R(rv):
        return lie.so3_exp(torch.as_tensor(np.asarray(rv, np.float32))).numpy()

    flows, _, Ts = render_window(K, poses, PLANES, H, W, r2R)
    bf = 0.5 * FX
    disps = [(bf / plane_depth(K, Ts[k][:3, :3], Ts[k][:3, 3], PLANES, H, W)).astype(np.float32)
             for k in range(N_FLOWS)]
    return flows, disps, bf


def _slam(scene):
    flows, disps, bf = scene
    slam = VOLDOR_SLAM(mode="stereo", device="cpu")
    slam.use_image_info = False
    slam.voldor_user_config = USER_CONFIG
    slam.set_cam_params(FX, FY, CX, CY, basefocal=bf)
    slam.disps = list(disps)
    slam.disp_loader_pt = len(disps)
    slam.flows = [flows[i] for i in range(N_FLOWS)]
    slam.N_FRAMES = N_FLOWS + 1
    slam.h, slam.w = H, W
    slam.flow_loader_pt = N_FLOWS
    return slam


class _ReadCounter:
    """Counts the host reads of tensors made while installed: each call of
    one of Tensor's READERS, outside another (``cpu`` only off the CPU)."""

    def __init__(self):
        self.n = 0
        self._depth = 0
        self._saved = {}

    def install(self):
        for name in READERS:
            self._saved[name] = torch.Tensor.__dict__.get(name)
            setattr(torch.Tensor, name, self._wrap(name, getattr(torch.Tensor, name)))

    def uninstall(self):
        for name, fn in self._saved.items():
            if fn is None:
                delattr(torch.Tensor, name)  # inherited from the C base
            else:
                setattr(torch.Tensor, name, fn)
        self._saved.clear()

    def _wrap(self, name, fn):
        def reader(t, *a, **k):
            if self._depth == 0 and (name != "cpu" or t.device.type != "cpu"):
                self.n += 1
            self._depth += 1
            try:
                return fn(t, *a, **k)
            finally:
                self._depth -= 1
        return reader


def _run(slam, counter=None, closes=None, profile_call=None):
    """process_vo to the end; with ``counter``, the independent count at
    each record's close goes to ``closes``; call number ``profile_call``
    runs under the profiler, whose events come back."""
    events = None
    k = 0
    while True:
        if counter is not None:
            start = counter.n
            real_close = profiling.close_record
            at_close = []

            def close():
                out = real_close()
                if out is not None:
                    at_close.append(counter.n - start)
                return out

            profiling.close_record = close
            counter.install()
        try:
            if k == profile_call:
                acts = [torch.profiler.ProfilerActivity.CPU]
                with torch.profiler.profile(activities=acts) as prof:
                    more = slam.process_vo()
                events = prof.events()
            else:
                more = slam.process_vo()
        finally:
            if counter is not None:
                counter.uninstall()
                profiling.close_record = real_close
        k += 1
        if not more:
            return events
        if counter is not None:  # the close at the call's vo_window event
            closes.append(at_close[0])


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """The stream run twice on one scene: with the logger open (reads
    counted independently, the second call profiled, the depth round's
    calls marked by a probe range) and with it closed."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    scene = _scene()
    real_round = engine._depth_round_core

    def probed(*a, **k):
        with torch.profiler.record_function("probe::depth_round_core"):
            return real_round(*a, **k)

    try:
        traced = _slam(scene)
        path = tmp_path_factory.mktemp("tracing") / "events.jsonl"
        traced.metrics.open(str(path))
        counter, closes = _ReadCounter(), []
        engine._depth_round_core = probed
        try:
            prof_events = _run(traced, counter, closes, profile_call=1)
        finally:
            engine._depth_round_core = real_round
        traced.metrics.close()
        plain = _slam(scene)
        _run(plain)
    finally:
        torch.set_num_threads(n_threads)
    events = [json.loads(line) for line in path.read_text().splitlines()]
    return dict(traced=traced, plain=plain, closes=closes, prof=prof_events,
                windows=[e for e in events if e["event"] == "vo_window"])


def test_every_vo_window_carries_the_record(streams):
    wins = streams["windows"]
    assert len(wins) >= 3
    fields = ("spans", "host_reads", "reads_by_site", "read_wait_s", "dispatched_fid", "counts")
    for e in wins:
        assert all(k in e for k in fields), e.keys()
        sp = e["spans"]
        assert set(sp) <= {"vo.call", *SPAN_PARENT}
        assert {"vo.call", "vo.collect"} <= set(sp)
        if e["dispatched_fid"] is not None:
            assert {"vo.dispatch", "engine.solve", "pose.sweep", "depth.round"} <= set(sp)
        assert sum(e["reads_by_site"].values()) == e["host_reads"] > 0
        for name, parent in SPAN_PARENT.items():
            if name in sp:
                assert 0 <= sp[name][1] <= sp[name][0] <= sp[parent][0]
        for parent in set(SPAN_PARENT.values()):
            kids = sum(sp[k][0] for k, p in SPAN_PARENT.items() if p == parent and k in sp)
            if parent in sp:
                assert kids <= sp[parent][0] + 1e-6
        # window_s is logged to 0.1 ms; the two clocks' edges lie microseconds apart
        assert abs(sp["vo.call"][0] - e["window_s"]) <= 0.01 * e["window_s"] + 5e-5 + 1e-5
        assert e["read_wait_s"] <= sp["vo.call"][0]
        # the hybrid sweep: the sequential one first in every window solved
        if e["dispatched_fid"] is not None:
            assert e["counts"].get("pose.sweep.seq", 0) >= 1
    # the pipeline: call k dispatches the window call k + 1 solves
    for a, b in zip(wins, wins[1:]):
        assert a["dispatched_fid"] == b["fid"]


def test_host_reads_equal_an_independent_count(streams):
    wins, closes = streams["windows"], streams["closes"]
    assert len(closes) == len(wins)
    assert [e["host_reads"] for e in wins] == closes


def test_tracing_leaves_poses_and_depths_bitwise_equal(streams):
    a, b = streams["traced"], streams["plain"]
    assert len(a.frames) == len(b.frames) == N_FLOWS + 1
    for fa, fb in zip(a.frames, b.frames):
        assert np.array_equal(fa.Tcw, fb.Tcw)
    assert a.kf_ids == b.kf_ids and a.kf_ids
    for k in a.kf_ids:
        assert np.array_equal(a.frames[k].depth, b.frames[k].depth)
        assert np.array_equal(a.frames[k].depth_conf, b.frames[k].depth_conf)


def _ranges(events, prefix):
    return [(e.name[len(prefix):], e.time_range.start, e.time_range.end)
            for e in events if e.name.startswith(prefix)]


def test_profiler_ranges_nest_as_the_spans(streams):
    ev = streams["prof"]
    # operator ranges: a user annotation would also be mirrored onto the
    # device's timeline, where a reading of the device's busy time counts it
    assert not any(e.is_user_annotation for e in ev if e.name.startswith("voldor::"))
    ranges = _ranges(ev, "voldor::")
    names = {n for n, _, _ in ranges}
    assert {"vo.call", "vo.dispatch", "engine.solve", "pose.sweep", "depth.round"} <= names
    for name, s, t in ranges:
        if name in SPAN_PARENT:
            parent = SPAN_PARENT[name]
            assert any(ps <= s and t <= pt for pn, ps, pt in ranges if pn == parent), name
    rounds = [(s, t) for n, s, t in ranges if n == "depth.round"]
    probes = _ranges(ev, "probe::")
    assert probes
    for _, s, t in probes:
        assert any(rs <= s and t <= rt for rs, rt in rounds)
    aten = [e for e in ev if e.name.startswith("aten::")
            and any(s <= e.time_range.start and e.time_range.end <= t for _, s, t in probes)]
    assert aten
    for e in aten:
        assert any(rs <= e.time_range.start and e.time_range.end <= rt for rs, rt in rounds)


# --------------------------------------------------------------------------
# (e) the benchmark's readers of the record
# --------------------------------------------------------------------------


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"reader_{name}", ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _event(window_s, reads, wait, spans):
    return {"event": "vo_window", "window_s": window_s, "host_reads": reads,
            "read_wait_s": wait, "spans": spans}


HAND_RECORD = {
    "window_s": 1.0,
    "events": [
        {"event": "keyframe"},
        _event(0.1, 30, 0.01, {
            "vo.call": [0.1, 0.01], "vo.inputs": [0.004, 0.004], "vo.upload": [0.001, 0.001],
            "vo.collect": [0.006, 0.002], "vo.dispatch": [0.07, 0.003],
            "engine.init": [0.005, 0.004], "engine.solve": [0.06, 0.008],
            "engine.covis": [0.002, 0.002]}),
        _event(0.3, 50, 0.02, {
            "vo.call": [0.3, 0.02], "vo.collect": [0.01, 0.001], "vo.dispatch": [0.2, 0.01],
            "engine.solve": [0.18, 0.02]}),
    ],
}


@pytest.mark.parametrize("name, expected", [
    ("vo_host_reads_per_call", 40.0),
    ("read_wait_share", 100.0 * 0.03 / 0.4),
    ("slam_host_share", 100.0 * (0.01 + 0.004 + 0.001 + 0.002 + 0.02 + 0.001) / 0.4),
    ("engine_host_share", 100.0 * (0.003 + 0.004 + 0.008 + 0.002 + 0.01 + 0.02) / 0.4),
])
def test_benchmark_readers_of_the_record(name, expected):
    mod = _reader(name)
    assert mod.value(HAND_RECORD) == pytest.approx(expected, rel=1e-12)
    # a program without the record (the parent's) gives nothing, and no error
    bare = {"window_s": 1.0, "events": [{"event": "vo_window", "window_s": 0.1}]}
    assert mod.value(bare) is None
    assert mod.value({"window_s": 1.0}) is None
