"""The ``tum-rgbd.handheld`` cell on the CPU: its pieces found by name, the
sensor's disparities that its driver feeds, its plain reference of the
scale fit against scipy's L-BFGS-B, its readers, and a small dry run of the
driver with the program's readings and the control's."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_support import BENCH, ROOT, one_thread, tiny_root  # noqa: F401 (fixtures)
from test_bench_imports import FORBIDDEN, _top_level_imports
import reference_rgbd
import run

CELL = "tum-rgbd.handheld"


def test_the_cell_resolves_to_its_driver_limits_and_metrics():
    cell = run.Cell(ROOT, CELL)
    assert cell.config["mode"] == "mono-scaled" and (cell.config["w"], cell.config["h"]) == (640, 480)
    assert (cell.config["fx"], cell.config["fy"], cell.config["cx"], cell.config["cy"]) == (535.4, 539.2, 320.1,
                                                                                          247.6)
    assert cell.driver_path == BENCH / "drivers" / "rgbd_stream.py"
    assert {"rot_err_deg", "t_err", "depth_err", "scale_fit_gap", "scale_fit_gap_float16",
            "fits_judged", "depth_maps_judged"} <= set(cell.limits["numbers"])
    lim = cell.limits["numbers"]
    assert lim["scale_fit_gap_float16"] == {**lim["scale_fit_gap_float16"], "kind": "min",
                                            "limit": lim["scale_fit_gap"]["limit"]}
    per = {m["name"] for m in cell.per_layer}
    assert {"scale_fit_share", "scale_fit_bytes_per_call", "cost_roofline", "pose_roofline",
            "device_idle.vo", "vo_window_ms_p50"} <= per
    assert not {"pgo_share", "falign_roofline"} & per
    assert {m["name"] for m in cell.end_to_end} == {"vo_fps", "vo_step_p95_ms", "setup_s"}
    for name in ("kitti-stereo.stream", "kitti-stereo-slam.mapped-drive"):
        assert not {"scale_fit_share", "scale_fit_bytes_per_call"} & {m["name"] for m in run.Cell(ROOT, name).per_layer}


def test_the_readers_read_only_the_new_spans_and_counters():
    share = run.Cell(ROOT, CELL).metric_reader("scale_fit_share")
    nbytes = run.Cell(ROOT, CELL).metric_reader("scale_fit_bytes_per_call")
    ev = [{"event": "vo_window", "window_s": 0.1, "counts": {"scale_fit_bytes": 2457600},
           "spans": {"vo.call": [0.1, 0.01], "vo.scale_fit": [0.02, 0.004], "vo.scale_copy": [0.005, 0.001]}},
          {"event": "vo_window", "window_s": 0.1, "counts": {"scale_fit_bytes": 2457600},
           "spans": {"vo.call": [0.1, 0.01], "vo.scale_fit": [0.02, 0.006], "vo.scale_copy": [0.005, 0.001]}}]
    assert share.value({"events": ev}) == pytest.approx(100 * 0.012 / 0.2)
    assert nbytes.value({"events": ev}) == 2457600
    # a program without them (the parent of this cell) reads nothing
    old = [{"event": "vo_window", "window_s": 0.1, "counts": {}, "spans": {"vo.call": [0.1, 0.01]}}]
    assert share.value({"events": old}) is None and nbytes.value({"events": old}) is None


def _driver_module():
    return run.load_module(BENCH / "drivers" / "rgbd_stream.py", "bench_driver_rgbd_stream_test")


def test_sensor_disparity_follows_the_configuration():
    cfg = json.loads((BENCH / "configs" / "tum-rgbd-fr3.json").read_text())
    s = cfg["sensor"]
    depth = np.random.default_rng(5).uniform(0.3, 6.0, (2, 40, 50))
    disp = _driver_module().sensor_disparity(depth, cfg)
    assert disp.dtype == np.float32 and disp.shape == depth.shape
    seen = (depth >= s["depth_min_m"]) & (depth <= s["depth_max_m"])
    assert np.all(disp[~seen] == 0) and np.all(disp[seen] > 0)
    assert np.all(disp / s["disparity_step_px"] == np.round(disp / s["disparity_step_px"]))
    assert np.abs(disp[seen] - cfg["bf"] / depth[seen]).max() <= s["disparity_step_px"] / 2 + 1e-6


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_reference_fit_agrees_with_scipys(seed):
    """The plain Newton fit against scipy's L-BFGS-B on the same objective
    (the program's ``slam/huber.py``) on seeded disparities with outliers."""
    from voldor_tpu_torch.slam.huber import huber_fit

    rng = np.random.default_rng(seed)
    n = (50, 3000, 10000)[seed - 1]
    src = rng.uniform(9, 47, n).astype(np.float32)
    dst = (np.round((rng.uniform(0.5, 2) * src + rng.normal(0, 0.05, n)) * 8) / 8).astype(np.float32)
    dst[: n // 20] = rng.uniform(0, 60, n // 20)
    coef, _, grad = reference_rgbd.huber(src, dst)
    assert grad < 1e-11
    assert abs(huber_fit(src, dst)[0] / coef - 1) < 1e-6
    assert abs(reference_rgbd.huber(src, dst, torch.float16)[0] / coef - 1) > 1e-6


def test_the_reference_loads_nothing_of_the_port():
    assert _top_level_imports(BENCH / "reference_rgbd.py") <= {"__future__", "numpy", "torch"}
    out = subprocess.run([sys.executable, "-c", "import sys, reference_rgbd\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(BENCH), "PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert not ({"voldor_tpu_torch"} | FORBIDDEN) & set(out.stdout.split())


def test_rgbd_dry_run_program_and_control(tmp_path, one_thread):
    """The rgbd_stream driver at 96x72 on the CPU (bf kept at 40.155: the
    pose sampler's range is in metres): the program's fits held to the
    reference, the stale control far from it, the poses metric."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    root = tiny_root(tmp_path, 96, 72, "")
    cfg = json.loads((root / "tum-rgbd.json").read_text())
    cfg["bf"] = 40.155
    (root / "tum-rgbd.json").write_text(json.dumps(cfg))
    cell = run.Cell(root, CELL, bench=bench)
    ctx = run.Context(cell, 2 ** 31 + 11, "cpu", False, torch)
    drv = cell.driver(ctx)
    drv.setup()
    drv.window(4.0)
    program, control = drv.judge(), drv.judge(control=True)
    drv.close()
    assert program["fits_judged"] >= 2 and program["fits_in_window"] >= program["fits_judged"]
    assert program["scale_fit_gap"] < 1e-6 < program["scale_fit_gap_float16"]
    assert control["scale_fit_gap"] > 1e-4
    assert program["t_err"] < 0.05 < control["t_err"]
    assert program["rot_err_block_max"] >= program["rot_err_block_first"] > 0
