"""The mapped drive (``drivers/drive.py``, ``reference_map.py``) on the CPU:
a tiny dry run of the cell through the harness, traced and not, with the
harness's look for a card skipped; the drive's scene; the plain PGO
against the program's on a small graph; what the reference imports."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from bench_support import BENCH, TINY_CONFIG, one_thread, tiny_root  # noqa: F401 (fixtures)
from test_bench_imports import _top_level_imports
import run

CELL = "kitti-stereo-slam.mapped-drive"
# the small map's settings (tests/test_torch_lc.py): at 192 x 96 a lap
# has four keyframes, and the cold vocabulary's scores sit near 0.27
SMALL_MAP = dict(lc_min_kf_distance=3, mp_spatial_sigma=2, lc_bow_score_thresh=0.25)
SMALL_LAPS = dict(lap_flows=12, step=[1.1, 0.05, 0.0])


@pytest.fixture
def small_drive(tmp_path):
    """A root and a benchmark directory whose mapped drive is cut to 192 x
    96, laps of 12 flows and the small map's settings."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    root = tiny_root(tmp_path, 192, 96, TINY_CONFIG)
    m = json.loads((root / "BENCHMARK.json").read_text())
    c = next(c for c in m["configs"] if c["name"] == "kitti-stereo-slam")
    cfg = json.loads(Path(c["file"]).read_text())
    cfg["slam"].update(SMALL_MAP)
    Path(c["file"]).write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "mapped-drive.json").read_text())
    tr.update(SMALL_LAPS)
    (bench / "traffic" / "mapped-drive.json").write_text(json.dumps(tr))
    return root, bench


@pytest.mark.parametrize("trace", [False, True])
def test_drive_dry_run(small_drive, one_thread, trace):
    root, bench = small_drive
    cell = run.Cell(root, CELL, bench=bench)
    out = run.run(cell, 2 ** 31 + 987654321, 4.0, trace, device="cpu")
    json.dumps(out)
    assert list(out)[-1] == "checks" and set(out["checks"]) == set(cell.limits["numbers"])
    assert out["device"]["platform"] == "cpu" and out["attempted"] >= 1
    if trace:
        # the program's spans and counters, of both threads, are read on the
        # CPU; the device's busy time and the kernels' roofline need the
        # card's trace
        assert {"pgo_share", "falign_share", "lc_host_share", "map_backlog_kf", "vo_window_ms_p50",
                "vo_host_reads_per_call", "read_wait_share", "slam_host_share",
                "engine_host_share"} <= set(out["metrics"])
        assert not {"device_idle.vo", "falign_roofline"} & set(out["metrics"])
    else:
        assert set(out["metrics"]) == {"vo_fps", "vo_step_p95_ms", "setup_s"}
    checks = out["checks"]
    assert checks["kf_in_graph"]["value"] == 1.0 and checks["global_pgo_runs"]["value"] >= 1
    assert checks["pgo_cost_gap"]["value"] < 1.001


def test_the_drive_keeps_every_pixel_on_a_plane_at_a_sane_depth():
    """Over the whole period at the cell's own size, for three seeds: every
    pixel sees a plane at a finite depth within 2-40, and the laps close."""
    import scene

    spec = run.load_module(BENCH / "drivers" / "drive.py", "bench_driver_drive_scene")
    cfg = json.loads((BENCH / "configs" / "kitti-stereo-slam.json").read_text())
    tr = json.loads((BENCH / "traffic" / "mapped-drive.json").read_text())
    K, planes = scene.intrinsics(cfg), scene.planes_of(cfg)
    for seed in (7, 2 ** 31 + 5, 4_000_000_007):
        inc = spec.drive_increments(seed, tr)
        assert inc.shape == (tr["laps"] * tr["lap_flows"], 6)
        Ts = scene.compose(inc)
        for lap in range(tr["laps"] + 1):
            np.testing.assert_allclose(Ts[lap * tr["lap_flows"]], np.eye(4), atol=1e-12)
        for k in range(len(inc)):
            d = scene.plane_depth(K, Ts[k][:3, :3], Ts[k][:3, 3], planes, cfg["h"], cfg["w"])
            assert np.all(np.isfinite(d)) and 2.0 <= d.min() and d.max() <= 40.0, (seed, k)
    # laps differ: revisits are near views, never identical ones
    one = spec.drive_increments(7, tr)
    lap = tr["lap_flows"]
    assert not np.allclose(one[:lap], one[lap:2 * lap])


def test_plain_pgo_matches_a_hand_solved_graph():
    """Three poses on a line, consistent edges plus a loop edge that
    disagrees: the plain LM's optimum splits the disagreement, its cost is
    the closed form, and the control (rows shifted) costs far more."""
    import reference_map as rm

    poses = np.zeros((3, 7))
    poses[:, 3] = [0.0, 1.0, 2.0]
    edges = np.array([[0, 1], [1, 2], [0, 2]])
    meas = np.zeros((3, 7))
    # X_end = M X_begin with M the motion from begin to end: end = begin + 1 along x
    meas[:, 3] = [-1.0, -1.0, -2.2]
    cov = np.tile(np.eye(7) * 0.01, (3, 1, 1))
    call = dict(poses=poses, poses_idx=np.arange(3), edges_idx=edges, edges_pose=meas,
                edges_covar=cov, out=poses)
    g = rm.PoseGraph(poses, np.arange(3), edges, meas, cov, False)
    state, cost, _ = g.solve()
    # pose 0 held; x1, x2 minimise (x1 - 1)^2 + (x2 - x1 - 1)^2 + (x2 - 2.2)^2
    np.testing.assert_allclose(state[0][1:, 0], [1.0 + 0.2 / 3, 2.0 + 0.4 / 3], atol=1e-9)
    assert cost == pytest.approx(0.5 * 100 * 3 * (0.2 / 3) ** 2, rel=1e-9)
    out = rm.pgo_check(call, np.arange(3), 2.0, False)
    assert out["pgo_cost_gap"] > 1.0 and out["pgo_pose_gap"] == pytest.approx(0.4 / 3 / 2.0, rel=1e-6)
    assert rm.pgo_check(call, np.arange(3), 2.0, False, control=True)["pgo_cost_gap"] > \
        out["pgo_cost_gap"]


def test_the_map_reference_imports_only_numpy():
    assert _top_level_imports(BENCH / "reference_map.py") <= {"__future__", "numpy"}
    assert _top_level_imports(BENCH / "roofline" / "falign_counts.py") <= {"__future__", "roofline"}
