"""The port's stereo mapped drive on the CPU, and OpenCV's raising
estimator in loop closure's geometry check.

* ``geometry_check`` counts a ``cv2.error`` from ``findFundamentalMat`` as
  no verified geometry (0.0), as it counts a missing mask.
* A drive whose geometry checks all raise, and one whose ``process_vo``
  raises: ``vo_thread`` sets ``end_of_vo`` in both, and the mapping thread
  returns instead of waiting for ever.
* A small stereo mapped drive of the benchmark's scene (two closed laps)
  through ``VOLDOR_SLAM`` with both threads, loop closure and images on, as
  the benchmark's ``drive`` driver runs it, judged by its plain reference
  (``benchmark/reference_map.py``): VO's published motions and the
  frame-alignment local links against the truth, every keyframe
  in the final graph, loop-closure links and a final global PGO, and the
  program's last global PGO against the plain float64 solver on the same
  graph.
"""

import importlib.util
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from voldor_tpu_torch.slam import slam_utils

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))  # the benchmark's own modules, after everything else

H, W = 96, 192
# the benchmark's camera and scene cut to W x H, its shipped mapping
# settings, and the small map's (as tests/test_torch_lc.py): keyframes
# three apart stay out of the local-link window, so a revisit links by loop
# closure, and the cold vocabulary's scores on the ~150 ORB features a
# frame of this size has sit near 0.27
TRAFFIC = dict(driver="drive", laps=2, lap_flows=12, step=[1.1, 0.05, 0.0], step_jitter=0.05,
               rot_noise=0.002, warm_laps=1, join_timeout_s=300)
SMALL_MAP = dict(lc_min_kf_distance=3, mp_spatial_sigma=2, lc_bow_score_thresh=0.25)
SEED = 2 ** 31 + 20261018


def _drive_module():
    spec = importlib.util.spec_from_file_location("bench_driver_drive_test", BENCH / "drivers" / "drive.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _config():
    import json

    cfg = json.loads((BENCH / "configs" / "kitti-stereo-slam.json").read_text())
    s = W / cfg["w"]
    cfg.update(w=W, h=H, fx=cfg["fx"] * s, fy=cfg["fy"] * s, cx=cfg["cx"] * s,
               cy=cfg["cy"] * H / cfg["h"], bf=cfg["bf"] * s,
               voldor_user_config="--n_poses_to_sample 1024 --depth_rand_samples 4")
    cfg["slam"] = dict(cfg["slam"], **SMALL_MAP)
    return cfg


@pytest.fixture(scope="module")
def drive():
    """The driver module and a driver over the small drive's period."""
    mod = _drive_module()
    ctx = types.SimpleNamespace(config=_config(), traffic=dict(TRAFFIC), seed=SEED, device="cpu",
                                trace=False, torch=torch)
    drv = mod.Driver(ctx)
    drv.period = mod.render_drive(SEED, ctx.config, ctx.traffic)
    drv.P = TRAFFIC["laps"] * TRAFFIC["lap_flows"]
    return mod, drv


@pytest.fixture
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _raising_estimator(*a, **k):
    import cv2

    raise cv2.error("OpenCV(4.13.0) matrix.cpp:72: error: (-215:Assertion failed) _rowRange")


def test_geometry_check_counts_an_opencv_error_as_no_geometry(monkeypatch):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    img = (rng.uniform(0, 1, (120, 160)) > 0.5).astype(np.uint8) * 200
    img = cv2.GaussianBlur(img, (3, 3), 0)
    kps, des = cv2.ORB_create().detectAndCompute(img, None)
    assert len(kps) >= 8 and slam_utils.geometry_check(kps, des, kps, des) > 0.5
    monkeypatch.setattr(cv2, "findFundamentalMat", _raising_estimator)
    assert slam_utils.geometry_check(kps, des, kps, des) == 0.0


@pytest.mark.parametrize("fault", ["estimator", "process_vo"])
def test_a_fault_in_the_vo_thread_ends_the_drive(drive, one_torch_thread, monkeypatch, fault):
    """vo_thread + mapping_thread over one lap: with every geometry check's
    estimator raising, the drive runs to its end; with process_vo raising
    at the second call, the VO thread dies. Either way end_of_vo is set and
    the mapping thread returns."""
    cv2 = pytest.importorskip("cv2")
    _, drv = drive
    slam = drv._system(TRAFFIC["lap_flows"] + 1)
    raised = []
    if fault == "estimator":
        def estimator(*a, **k):
            raised.append(1)
            _raising_estimator()

        monkeypatch.setattr(cv2, "findFundamentalMat", estimator)
    else:
        real, calls = slam.process_vo, []

        def process_vo():
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("a fault planted in process_vo")
            return real()

        slam.process_vo = process_vo
    died = []

    def vo():
        try:
            slam.vo_thread()
        except RuntimeError as e:
            died.append(e)

    threads = [threading.Thread(target=vo, daemon=True),
               threading.Thread(target=slam.mapping_thread, daemon=True)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert slam.end_of_vo
    if fault == "estimator":
        assert raised and not died and slam.fid_cur == slam.N_FRAMES
    else:
        assert died and slam.fid_cur < slam.N_FRAMES - 1


def test_small_mapped_drive_against_the_plain_reference(drive, one_torch_thread):
    mod, drv = drive
    drv.slam = drv._system(drv.P + 1)
    drv.window(600.0)  # runs to the sequence's end
    assert drv.f1 == drv.P
    program = drv.judge()
    control = drv.judge(control=True)
    # VO: every published motion against the true increment
    assert program["rot_err_deg"] < 0.1 and program["t_err"] < 0.02
    assert control["t_err"] > 10 * program["t_err"]
    # every frame-alignment local link against the true motion between its keyframes
    assert program["link_rot_err_deg"] < 0.1 and program["link_t_err"] < 0.02
    assert control["link_t_err"] > 10 * program["link_t_err"]
    # nothing dropped: every keyframe in the final graph, a loop-closure
    # link, and a final global PGO over every frame
    assert program["kf_in_graph"] == 1.0
    assert program["lc_links"] >= 1 and program["global_pgo_runs"] >= 1
    # the map against the truth, and the control's stale map far worse
    assert program["map_ate"] < 0.02 and control["map_ate"] > 3 * program["map_ate"]
    # the program's PGO reached the plain float64 solver's optimum of its graph
    assert 1.0 - 1e-3 < program["pgo_cost_gap"] < 1.0 + 1e-3
    assert program["pgo_pose_gap"] < 1e-3
    assert control["pgo_cost_gap"] > 10.0
    # the plain optimum held in float16 reads far above the program's gap
    assert program["pgo_cost_gap_float16"] > 1.0 + 1e-3
