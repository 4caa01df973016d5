"""The mapping thread's trace (``map_pass`` events, ``utils/profiling.py``)
and loop closure's span in the VO record, on the CPU.

* A small stereo mapped drive (the benchmark's scene, both threads, loop
  closure on) with the metrics logger open: every pass of the mapping
  thread is one ``map_pass`` event of its kind (``map.register``,
  ``map.links``, ``pgo.solve``) with its spans nested in it and its
  counters; the counters agree with what the drive left (keyframes
  registered, loop-closure edges, the PGO events' sizes); keyframe windows
  carry ``lc.query``.
* With the logger closed the mapping thread opens no record.
* The benchmark's readers of these fields, on a hand-made record, and the
  frozen falign work counts by hand.
"""

import importlib.util
import json
import sys
import types
from pathlib import Path

import pytest
import torch

from voldor_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

import test_torch_mapped_drive as small  # noqa: E402 (the small drive's scene and settings)


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _driver():
    mod = small._drive_module()
    ctx = types.SimpleNamespace(config=small._config(), traffic=dict(small.TRAFFIC), seed=small.SEED,
                                device="cpu", trace=False, torch=torch)
    drv = mod.Driver(ctx)
    drv.period = mod.render_drive(small.SEED, ctx.config, ctx.traffic)
    return drv


def test_map_pass_events_spans_and_counters(tmp_path, one_torch_thread):
    drv = _driver()
    slam = drv._system(2 * small.TRAFFIC["lap_flows"] + 1)
    path = tmp_path / "events.jsonl"
    slam.metrics.open(str(path))
    drv._drive(slam)
    slam.metrics.close()
    events = [json.loads(line) for line in path.read_text().splitlines()]
    passes = [e for e in events if e["event"] == "map_pass"]
    kinds = {e["kind"] for e in passes}
    assert kinds == {"map.register", "map.links", "pgo.solve"}
    children = {"map.register": set(), "map.links": {"falign.setup", "falign.lm", "falign.finish"},
                "pgo.solve": {"pgo.snapshot", "pgo.lm", "pgo.apply"}}
    for e in passes:
        spans = e["spans"]
        root = spans[e["kind"]]
        assert set(spans) <= {e["kind"]} | children[e["kind"]], spans
        assert sum(spans[c][0] for c in children[e["kind"]] if c in spans) <= root[0] + 1e-6
        assert all(0 <= v[1] <= v[0] + 1e-6 for v in spans.values())
    links = [e for e in passes if e["kind"] == "map.links"]
    pgos = [e for e in passes if e["kind"] == "pgo.solve"]
    regs = [e for e in passes if e["kind"] == "map.register"]
    for e in links:
        assert set(e["spans"]) == {"map.links"} | children["map.links"]
        c = e["counts"]
        assert c["falign_pairs"] >= 1 and c["falign_chunks"] >= 1
        assert e["reads_by_site"]["falign.flags"] == c["falign_chunks"]
    # every keyframe registered once, in passes that each counted its backlog
    assert sum(e["counts"]["map_backlog_kf"] for e in regs) == len(slam.kf_ids)
    assert all(e["counts"]["map_backlog_kf"] >= 1 for e in regs)
    # every loop-closure edge counted where its link was accepted
    lc = sum(e.edge_type == "falign-lc" for e in slam.edges)
    assert lc >= 1 and sum(e["counts"].get("lc_links", 0) for e in links) == lc
    # each PGO pass counts the sizes its pgo event logs, and its iterations
    logged = [e for e in events if e["event"] == "pgo"]
    assert [(e["counts"]["pgo_poses"], e["counts"]["pgo_edges"]) for e in pgos] == \
        [(e["n_frames"], e["n_edges"]) for e in logged]
    assert all(e["counts"]["pgo_iters"] >= 1 for e in pgos)
    assert set(pgos[-1]["spans"]) == {"pgo.solve"} | children["pgo.solve"]
    # loop closure's host work in the VO record of keyframe windows
    wins = [e for e in events if e["event"] == "vo_window"]
    assert sum("lc.query" in e["spans"] for e in wins) >= 1


def test_no_record_on_the_mapping_thread_with_the_logger_closed(one_torch_thread, monkeypatch):
    drv = _driver()
    slam = drv._system(6)
    opened = []
    real = profiling.open_record
    monkeypatch.setattr(profiling, "open_record", lambda root: (opened.append(root), real(root)))
    drv._drive(slam)
    assert not opened and not profiling.recording()


def test_readers_of_the_mapping_trace():
    rec = {"window_s": 10.0, "events": [
        {"event": "map_pass", "kind": "pgo.solve", "spans": {"pgo.solve": [2.0, 0.1], "pgo.lm": [1.5, 1.5]},
         "counts": {"pgo_poses": 10}},
        {"event": "map_pass", "kind": "pgo.solve", "spans": {"pgo.solve": [1.0, 0.1]}, "counts": {}},
        {"event": "map_pass", "kind": "map.links", "spans": {
            "map.links": [1.0, 0.2], "falign.setup": [0.2, 0.2], "falign.lm": [0.4, 0.3],
            "falign.finish": [0.2, 0.2]}, "counts": {"falign_pairs": 3}},
        {"event": "map_pass", "kind": "map.register", "spans": {"map.register": [0.01, 0.01]},
         "counts": {"map_backlog_kf": 3}},
        {"event": "map_pass", "kind": "map.register", "spans": {"map.register": [0.01, 0.01]},
         "counts": {"map_backlog_kf": 1}},
        {"event": "vo_window", "spans": {"vo.call": [0.1, 0.01], "lc.query": [0.05, 0.04]}},
        {"event": "vo_window", "spans": {"vo.call": [0.1, 0.01]}},
    ], "profile": {"busy_s": 0.5, "window_s": 2.0, "falign": {"kernel_s": 0.02},
                   "work": {"falign": 0.001}}}
    assert _reader("pgo_share").value(rec) == pytest.approx(30.0)
    assert _reader("falign_share").value(rec) == pytest.approx(8.0)
    assert _reader("lc_host_share").value(rec) == pytest.approx(0.4)
    assert _reader("map_backlog_kf").value(rec) == 2.0
    assert _reader("device_idle.vo").value(rec) == pytest.approx(75.0)
    assert _reader("falign_roofline").value(rec) == pytest.approx(5.0)
    # a program without the mapping trace gives nothing, and raises nothing
    bare = {"window_s": 10.0, "events": [{"event": "vo_window", "spans": {"vo.call": [0.1, 0.1]}}],
            "profile": {}}
    for name in ("pgo_share", "falign_share", "lc_host_share", "map_backlog_kf", "device_idle.vo",
                 "falign_roofline"):
        assert _reader(name).value(bare) is None, name


def test_falign_work_counts_by_hand():
    from roofline import counts, falign_counts as fc

    assert fc.FALIGN_PX == (495 + 3 * 10 + 1, 11)
    assert fc.grid_px(185, 613, 4) == 47 * 154
    F = counts.FP32_INSTR_PER_S
    # one pair (two evaluations) on a 2 x 2 grid (h = w = 2, stride 1), no
    # coarse phase, one LM iteration: four linearisations' and a scores
    # pass's operations (bytes are far below them), the solve's factor
    px_ops = 4 * 2 * (526 + 190)
    lin = max(px_ops / F, 11 * 4 * 2 / counts.SFU_PER_S)
    solve = fc.lm_solve_piece(2)
    lm = max((px_ops + solve[0]) / F, (11 * 8 + solve[1]) / counts.SFU_PER_S)
    score = max(4 * 2 * fc.FALIGN_SCORE_PX[0] / F, 4 * 2 * fc.FALIGN_SCORE_PX[1] / counts.SFU_PER_S)
    got = fc.call_bound_s(1, 2, 2, 1, 0, [1], [0])
    assert got == pytest.approx(lin + lm + lin + score)
