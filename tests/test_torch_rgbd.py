"""RGB-D VO as ``mono-scaled`` in the port, on the CPU, held to the plain
reference of the scale fit (``tests/plain_rgbd.py``, a copy of the
benchmark's ``benchmark/reference_rgbd.py``).

* ``VOLDOR_SLAM._mono_scaled_fit`` against the plain fit on seeded random
  maps with sensor holes and outliers: more confident pixels than the fit
  takes (the pixel draw), fewer, scales clipped at both ends, and fewer than
  10 pixels (no fit); the pixels and iterations it counts in the tracer.
* A small handheld RGB-D stream of the benchmark's office scene (96x72, the
  TUM fr3 intrinsics scaled) through ``process_vo`` with the sensor's holed,
  quantised disparities: every published motion and each window's depth
  judged at metric scale against the scene's truth, and the fit's spans and
  counters in every ``vo_window`` event.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from voldor_tpu_torch.slam.system import VOLDOR_SLAM
from voldor_tpu_torch.utils import profiling

import plain_rgbd

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))  # the benchmark's own modules, after everything else

BF = 40.155
SEED = 2 ** 31 + 20261019


def test_plain_copy_is_the_benchmark_reference():
    def body(p):
        s = p.read_text()
        return s[s.index('"""', 3) + 3:]

    assert body(ROOT / "tests" / "plain_rgbd.py") == body(BENCH / "reference_rgbd.py")


# --------------------------------------------------------------------------
# the fit alone
# --------------------------------------------------------------------------


def _window(case, seed):
    """A window's host maps as the fit finds them (depth at a mono scale
    1 / s_true of the truth, confidence), the sensor's disparity with holes
    and 5% outliers, and the window's poses and covariances."""
    h, w = (120, 160) if case == "subsample" else (60, 80)
    s_true = {"clip_high": 25.0, "clip_low": 0.04}.get(case, 1.7)
    rng = np.random.default_rng(seed)
    true = rng.uniform(0.8, 4.4, (h, w))
    depth = (true / s_true * (1 + rng.normal(0, 0.002, (h, w)))).astype(np.float32)
    conf = rng.uniform(0.0, 1.0, (h, w)).astype(np.float32)
    disp = np.round(BF / true * 8) / 8
    disp[(true > 4.0) | (rng.uniform(size=(h, w)) < 0.1)] = 0.0
    out = rng.uniform(size=(h, w)) < 0.05
    disp[out] = rng.uniform(0, 60, int(out.sum()))
    if case == "too_few":
        conf[:] = 0.0
        conf[0, :9] = 1.0
    poses = rng.normal(0, 0.1, (4, 6)).astype(np.float32)
    covar = np.tile(np.diag(rng.uniform(1e-4, 1e-2, 6)).astype(np.float32), (4, 1, 1))
    return dict(depth=depth, depth_conf=conf, poses=poses, poses_covar=covar), disp.astype(np.float32), s_true


@pytest.mark.parametrize("case", ["subsample", "all_pixels", "clip_high", "clip_low", "too_few"])
def test_mono_scaled_fit_is_the_plain_fit(case):
    """The program's scale against the plain fit's on the very inputs, with
    the program's pixel draw replayed from its generator's state. The
    tolerance, 1e-6 relative: the program stops L-BFGS-B at a projected
    gradient of 1e-5 on the summed objective (or a relative decrease of
    2.2e-9) and fits float32 disparities, the plain fit runs Newton in
    float64 on the mean to its last resolvable step; they part by 1e-8 or
    less on these maps."""
    ret, disp, s_true = _window(case, 24)
    slam = VOLDOR_SLAM(mode="mono-scaled", device="cpu")
    slam.set_cam_params(535.4, 539.2, 320.1, 247.6, basefocal=BF)
    slam.disps = [disp]
    slam.depth_scaling_rng = np.random.default_rng(7)
    state = slam.depth_scaling_rng.bit_generator.state
    r = {k: v.copy() for k, v in ret.items()}
    profiling.open_record("test")
    slam._mono_scaled_fit(r)
    counts = profiling.close_record()["counts"]
    s_ref, n_px, grad = plain_rgbd.scale(ret["depth"], ret["depth_conf"], disp, BF, state)
    s_prog = r["depth"].astype(np.float64) / ret["depth"]
    np.testing.assert_allclose(s_prog, s_ref, rtol=1e-6)
    np.testing.assert_allclose(r["poses"][:, 3:], ret["poses"][:, 3:] * s_ref, rtol=1e-6)
    np.testing.assert_array_equal(r["poses"][:, :3], ret["poses"][:, :3])
    np.testing.assert_allclose(r["poses_covar"][:, 3:, 3:], ret["poses_covar"][:, 3:, 3:] * s_ref ** 2,
                               rtol=2e-6)
    assert counts["scale_fit_px"] == n_px
    if case == "too_few":
        assert n_px < 10 and s_ref == 1.0 and "scale_fit_iters" not in counts
        return
    assert counts["scale_fit_iters"] > 0 and grad < 1e-11
    assert n_px == 10000 if case == "subsample" else n_px < 10000
    expected = float(np.clip(s_true, 0.1, 10))
    assert abs(s_ref / expected - 1) < 0.01  # the fit finds the true scale


def test_the_fit_runs_blas_on_one_thread(monkeypatch):
    """L-BFGS-B inside ``huber_fit`` sees every loaded OpenBLAS on one
    thread, the thread counts are as before once it returns, and the
    coefficient is bitwise the one of the same minimisation run without the
    limit, at the fit's largest draw of 10,000 pixels."""
    from scipy import optimize

    from voldor_tpu_torch.slam import huber

    pools = huber._openblas_threads()
    assert pools  # numpy's and scipy's wheels each bundle an OpenBLAS
    before = [get() for get, _ in pools]
    rng = np.random.default_rng(11)
    src = rng.uniform(1, 80, 10000).astype(np.float32)
    dst = (0.7 * src + rng.normal(0, 0.3, src.size)).astype(np.float32)
    dst[:1500] = rng.uniform(0, 80, 1500)
    free = optimize.minimize(
        huber._loss_and_grad, np.array([0.0, 1.0]), method="L-BFGS-B", jac=True,
        args=(src.reshape(-1, 1), dst, huber.EPSILON, huber.ALPHA, np.ones(src.size)),
        options={"maxiter": huber.MAX_ITER, "gtol": huber.TOL},
        bounds=[(-np.inf, np.inf), (np.finfo(np.float64).eps * 10, np.inf)])
    seen = []
    objective = huber._loss_and_grad

    def spy(*args):
        seen.append([get() for get, _ in pools])
        return objective(*args)

    monkeypatch.setattr(huber, "_loss_and_grad", spy)
    coef, iters = huber.huber_fit(src, dst)
    assert seen and all(s == [1] * len(pools) for s in seen)
    assert [get() for get, _ in pools] == before
    assert coef == free.x[0] and iters == free.nit


def test_plain_fit_in_float16_misses_by_far_more():
    """The yardstick of the cell's ``scale_fit_gap_float16``: the plain fit
    computed in float16 parts from the float64 fit by far more than the
    program does."""
    ret, disp, _ = _window("subsample", 25)
    state = np.random.default_rng(3).bit_generator.state
    s64 = plain_rgbd.scale(ret["depth"], ret["depth_conf"], disp, BF, state)[0]
    s16 = plain_rgbd.scale(ret["depth"], ret["depth_conf"], disp, BF, state, dtype=torch.float16)[0]
    assert 1e-5 < abs(s16 / s64 - 1) < 1e-2


# --------------------------------------------------------------------------
# a small handheld stream
# --------------------------------------------------------------------------

H, W = 72, 96


def _driver_module():
    spec = importlib.util.spec_from_file_location("bench_driver_rgbd_test", BENCH / "drivers" / "rgbd_stream.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """One period of the benchmark's handheld traffic at 96x72 (the
    intrinsics scaled; bf kept at the configuration's 40.155: the pose
    sampler's depth range bf / 200 to bf is in metres, and a bf scaled with
    the width would leave out the monocular start's depths at this size),
    through ``process_vo`` with the metrics logger open."""
    import scene

    cfg = json.loads((BENCH / "configs" / "tum-rgbd-fr3.json").read_text())
    traffic = json.loads((BENCH / "traffic" / "handheld.json").read_text())
    s = W / cfg["w"]
    cfg.update(w=W, h=H, fx=cfg["fx"] * s, fy=cfg["fy"] * s, cx=cfg["cx"] * s, cy=cfg["cy"] * H / cfg["h"])
    period = scene.stream_period(SEED, cfg, traffic, False)
    disp = _driver_module().sensor_disparity(period["depths"], cfg)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        slam = VOLDOR_SLAM(mode="mono-scaled", device="cpu")
        slam.use_image_info = False
        slam.voldor_user_config = cfg["voldor_user_config"]
        slam.set_cam_params(cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"], basefocal=cfg["bf"])
        n = len(period["flows"])
        slam.flows, slam.disps = list(period["flows"]), list(disp)
        slam.N_FRAMES, slam.h, slam.w = n + 1, H, W
        slam.flow_loader_pt = slam.disp_loader_pt = n
        path = tmp_path_factory.mktemp("rgbd") / "events.jsonl"
        slam.metrics.open(str(path))
        while slam.process_vo():
            pass
        slam.metrics.close()
    finally:
        torch.set_num_threads(n_threads)
    events = [json.loads(line) for line in path.read_text().splitlines()]
    return dict(slam=slam, period=period, disp=disp,
                windows=[e for e in events if e["event"] == "vo_window"])


def test_stream_is_metric_against_the_scene(stream):
    """Every published motion of the period and each window's depth map at
    scale 1, against the truth the scene was rendered from. The first
    window has no depth prior: its monocular gauge (a mean step of 1) needs
    a scale of ~0.083, and the fit's clip to [0.1, 10] leaves it ~21% long;
    the windows after it take metric priors, and their fits hold them."""
    import reference

    slam, period = stream["slam"], stream["period"]
    assert not any(e.edge_type == "none" for e in slam.edges)  # no frame lost
    T = np.stack([np.asarray(f.Tcw, np.float64) for f in slam.frames])
    motions = reference.relative_motions(T)
    n = len(period["increments"])
    errs = reference.pose_errors(motions[:n], period["increments"], metric=True)
    first = stream["windows"][0]["vo_step"]
    assert np.all((errs["t_err"][:first] > 0.1) & (errs["t_err"][:first] < 0.35))
    assert errs["rot_err_deg"].max() < 0.5
    assert errs["t_err"][first:].max() < 0.05
    starts = [e["fid"] for e in stream["windows"][1:]]  # each window's frame 0 keeps its fitted map
    assert len(starts) >= 3
    for f in starts:
        assert reference.depth_error(slam.frames[f].depth, period["depths"][f], 1.0) < 0.05


def test_every_window_carries_the_fit_spans_and_counters(stream):
    wins = stream["windows"]
    assert len(wins) >= 3
    for e in wins:
        sp, c = e["spans"], e["counts"]
        assert {"vo.scale_fit", "vo.scale_copy"} <= set(sp)
        assert 0 <= sp["vo.scale_copy"][0] <= sp["vo.scale_fit"][0] <= sp["vo.call"][0]
        assert c["scale_fit_bytes"] == 2 * H * W * 4
        assert 10 <= c["scale_fit_px"] <= min(10000, H * W)
        assert c["scale_fit_iters"] > 0
