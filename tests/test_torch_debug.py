"""The VO engine's debug entry points in the PyTorch port, against the JAX
package on the CPU: ``save_result``, ``utils/debug_viz.dump_window_debug``
and the SLAM layer's ``debug_dir``, the legacy KITTI ground estimate, the
deprecated in-engine ``resize_factor``, and the reference-structured
``solve_stepwise``.

Inputs are seeded numpy arrays fed to both packages; tolerances are stated
per test. PNG files are written through cv2 on both sides, but only the
``.npy`` and text files are compared: the PNG encoder differs between
OpenCV builds.
"""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voldor_tpu.config import VoldorConfig as JConfig
from voldor_tpu.ops import lie as jlie
from voldor_tpu.utils import debug_viz as jdebug
from voldor_tpu.vo import engine as jengine
from voldor_tpu.vo.kitti_ground import estimate_kitti_ground as j_kitti
from voldor_tpu_torch.config import VoldorConfig as TConfig
from voldor_tpu_torch.slam.system import VOLDOR_SLAM as TSLAM
from voldor_tpu_torch.utils import debug_viz as tdebug
from voldor_tpu_torch.utils.evaluation import ate_rmse
from voldor_tpu_torch.vo import engine as tengine
from voldor_tpu_torch.vo.kitti_ground import estimate_kitti_ground as t_kitti

from synthetic import render_window
from test_slam import CX, CY, FX, FY, H, W, _make_sequence

CFG = dict(fx=80.0, fy=80.0, cx=48.0, cy=36.0, basefocal=40.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel
    processes, and every process's default thread pool at once
    oversubscribes the cores many times over (as tests/test_torch_lc.py's
    one_torch_thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _state(rng, n=3, h=24, w=32):
    return dict(
        depth=rng.uniform(2.0, 9.0, (h, w)).astype(np.float32),
        rigidness=rng.uniform(0.0, 1.0, (n, h, w)).astype(np.float32),
        poses6=rng.normal(0.0, 0.3, (n, 6)).astype(np.float32),
        flows=rng.normal(0.0, 4.0, (n, h, w, 2)).astype(np.float32),
    )


def _npy_files(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".npy"))


@pytest.mark.parametrize("save_everything", [False, True])
def test_save_result_matches_jax(tmp_path, save_everything):
    """One engine state (3 frames, 2 registered) written by both packages'
    save_result: the same file set; depth, rigidness sum, rigidness and
    flow visualisation arrays within 1e-6; camera_pose.txt identical."""
    st = _state(np.random.default_rng(4))
    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    for c in (jcfg, tcfg):
        c.silent = True
        c.save_everything = save_everything
    je = jengine.VoldorEngine(jcfg)
    te = tengine.VoldorEngine(tcfg, device="cpu")
    for e, conv in ((je, jnp.asarray), (te, torch.as_tensor)):
        for k, v in st.items():
            setattr(e, k, conv(v))
        e.n_flows, e.n_flows_init = 2, 3
    jengine.save_result(je, str(tmp_path / "jax"))
    tengine.save_result(te, str(tmp_path / "port"))
    names = _npy_files(tmp_path / "jax")
    assert names == _npy_files(tmp_path / "port")
    assert len(names) == (8 if save_everything else 2)
    assert (tmp_path / "port" / "depth.png").exists()
    for n in names:
        np.testing.assert_allclose(np.load(tmp_path / "port" / n), np.load(tmp_path / "jax" / n),
                                   rtol=1e-6, atol=1e-6, err_msg=n)
    txt = (tmp_path / "port" / "camera_pose.txt").read_text()
    assert txt == (tmp_path / "jax" / "camera_pose.txt").read_text()
    assert len(txt.strip().split("\n")) == 2


def test_dump_window_debug_matches_jax(tmp_path):
    """A voldor() return with rigidness (as --save_everything gives it):
    both packages' dump writes the same .npy arrays, equal; the PNG panels
    exist on both sides."""
    st = _state(np.random.default_rng(5), n=4)
    vo_ret = dict(depth=st["depth"], depth_conf=st["rigidness"][0], rigidness=st["rigidness"],
                  n_registered=4, poses=st["poses6"])
    jdebug.dump_window_debug(str(tmp_path / "jax"), 12, vo_ret)
    tdebug.dump_window_debug(str(tmp_path / "port"), 12, vo_ret)
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "port"))
    names = _npy_files(tmp_path / "jax")
    assert names == ["window_000012_depth.npy", "window_000012_depth_conf.npy",
                     "window_000012_rigidness.npy"]
    for n in names:
        np.testing.assert_array_equal(np.load(tmp_path / "port" / n), np.load(tmp_path / "jax" / n))
    for name, lo_hi in (("invdepth", None), ("depth_conf", (0.0, 1.0))):
        src = 5.0 / np.maximum(st["depth"], 1e-12) if lo_hi is None else st["rigidness"][0]
        lo, hi = lo_hi or (0.0, np.nanpercentile(src, 99))
        np.testing.assert_array_equal(tdebug._to_u8(src, lo, hi), jdebug._to_u8(src, lo, hi))
    np.testing.assert_array_equal(tdebug._mosaic(st["rigidness"], 2), jdebug._mosaic(st["rigidness"], 2))


def test_slam_debug_dir_writes_every_window(tmp_path):
    """VOLDOR_SLAM(mode="mono", device="cpu") with debug_dir over a 4-flow
    sequence: every window's depth, confidence and rigidness maps (one
    rigidness map per flow of the window) are written, finite."""
    _, flows, _, _ = _make_sequence(4)
    slam = TSLAM(mode="mono", device="cpu")
    slam.use_image_info = False
    slam.voldor_user_config = "--n_poses_to_sample 1024 --depth_rand_samples 4"
    slam.set_cam_params(FX, FY, CX, CY)
    slam.flows = [flows[i] for i in range(flows.shape[0])]
    slam.N_FRAMES = flows.shape[0] + 1
    slam.h, slam.w = H, W
    slam.flow_loader_pt = flows.shape[0]
    slam.debug_dir = str(tmp_path / "dbg")
    fids = []
    while True:
        fid = slam.fid_cur
        if not slam.process_vo():
            break
        fids.append(fid)
    assert len(slam.frames) == slam.N_FRAMES
    for fid in fids:
        tag = tmp_path / "dbg" / f"window_{fid:06d}"
        depth = np.load(f"{tag}_depth.npy")
        rig = np.load(f"{tag}_rigidness.npy")
        assert depth.shape == (H, W) and np.isfinite(depth).all()
        assert np.load(f"{tag}_depth_conf.npy").shape == (H, W)
        assert rig.shape[1:] == (H, W) and 1 <= rig.shape[0] <= flows.shape[0] - fid
        assert os.path.exists(f"{tag}_invdepth.png")


def _ground_scene():
    """tests/test_aux.py:68's camera 1.5 above a tilted ground plane."""
    h, w = 64, 96
    K = np.array([[80.0, 0, 48], [0, 80.0, 32], [0, 0, 1]], np.float32)
    n = np.asarray([0.0, -0.9486833, -0.31622777])
    ys, xs = np.mgrid[0:h, 0:w]
    rays = np.stack([(xs - 48) / 80.0, (ys - 32) / 80.0, np.ones_like(xs, np.float64)], -1)
    denom = rays @ n
    depth = np.where(np.abs(denom) > 1e-6, -1.5 / denom, 1e4).astype(np.float32)
    return np.clip(depth, 0.1, 100.0), K, n


def test_kitti_ground_matches_jax():
    """The same depth map through both packages: both meet
    tests/test_aux.py's gates (height 1.5 within 0.1, normal within 0.98 of
    the truth, confidence > 0.3); the port's height within 2e-3 and its
    normal within 2e-3 of the JAX package's, its confidence no lower.

    The JAX package's box sums run in float32 and cancel: a 1-ulp change of
    the depth moves its height by 2.6e-4, its normal by 1e-3 and its
    confidence by 0.004 (1.49888 / 0.7734 here, against the truth 1.5).
    The port accumulates in float64 and reads 1.49998 / 1.0."""
    depth, K, n = _ground_scene()
    g_j = j_kitti(depth, K, roi_frac=0.4, holo_width=3)
    g_t = t_kitti(torch.as_tensor(depth), K, roi_frac=0.4, holo_width=3)
    for g in (g_j, g_t):
        assert abs(g.height - 1.5) < 0.1 and abs(np.dot(g.normal, n)) > 0.98
        assert g.confidence > 0.3
    np.testing.assert_allclose(g_t.height, g_j.height, atol=2e-3)
    np.testing.assert_allclose(g_t.normal, np.asarray(g_j.normal), atol=2e-3)
    assert g_t.confidence >= g_j.confidence


def test_resize_factor_init_matches_jax():
    """--resize_factor 0.5 with a disparity map: the resized flows, the
    disparity prior and the scaled intrinsics within 1e-5 of the JAX
    engine's (float32 transfer on both sides)."""
    rng = np.random.default_rng(9)
    flows = rng.normal(0.0, 3.0, (2, 37, 50, 2)).astype(np.float32)
    disp = rng.uniform(2.0, 20.0, (37, 50)).astype(np.float32)
    cfgs = []
    for C in (JConfig, TConfig):
        c = C(**CFG)
        c.read_config("--silent --resize_factor 0.5 --transfer_dtype float32")
        cfgs.append(c)
    je = jengine.VoldorEngine(cfgs[0]).init(flows, disparity=disp)
    te = tengine.VoldorEngine(cfgs[1], device="cpu").init(flows, disparity=disp)
    assert (te.h, te.w) == (je.h, je.w) == (18, 25)
    np.testing.assert_allclose(te.flows.numpy(), np.asarray(je.flows), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(te.priors.numpy(), np.asarray(je.priors), rtol=1e-5, atol=1e-5)
    for k in ("fx", "fy", "cx", "cy"):
        assert abs(getattr(te.cfg, k) - getattr(je.cfg, k)) <= 1e-5
    assert te.cfg.fx == 40.0


def _r2R(rv):
    return np.asarray(jlie.so3_exp(jnp.asarray(np.asarray(rv, np.float32))))


def test_solve_stepwise_matches_solve(monkeypatch):
    """The port's solve_stepwise (one call per phase: sequential sweep, depth
    round) and its fused solve on the 72x96 three-plane window of
    tests/test_torch_slice.py: both meet that test's ground-truth gates
    (rotation atol 8e-3, mono-gauge translation atol 0.05, median relative
    depth error < 0.08) and lie within 0.02 of each other in Sim3 ATE over
    the extent. The fused solve also runs the KITTI ground epilogue."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    n = 3
    K = np.array([[80.0, 0, 48.0], [0, 80.0, 36.0], [0, 0, 1]], np.float32)
    planes = [(np.asarray(v) / np.linalg.norm(v), d) for v, d in
              (([0.1, 0.15, 1.0], 8.0), ([-0.35, 0.1, 1.0], 6.5), ([0.3, -0.25, 1.0], 7.0))]
    poses = np.zeros((n, 6), np.float32)
    rng = np.random.default_rng(7)
    for f in range(n):
        poses[f, :3] = rng.normal(0, 0.01, 3)
        poses[f, 3:6] = [0.5 + 0.05 * rng.normal(), 0.05 * rng.normal(), 0.3]
    flows, depth0, _ = render_window(K, poses, planes, 72, 96, _r2R)
    s = n / np.linalg.norm(poses[:, 3:6], axis=1).sum()
    base = ("--silent --max_iters 4 --n_poses_to_sample 2048 --depth_rand_samples 6 "
            "--depth_local_prop_width 16 --transfer_dtype float32")
    engines = []
    for extra in ("", " --kitti_estimate_ground 1"):
        cfg = TConfig(**CFG)
        cfg.read_config(base + extra)
        engines.append(tengine.VoldorEngine(cfg, device="cpu").init(flows))
    step, fused = engines
    assert step.solve_stepwise() == 4
    fused.solve()
    inner = np.s_[8:-8, 8:-8]
    trajs = []
    for e in (step, fused):
        assert e.n_flows == n
        np.testing.assert_allclose(e.poses[:, :3], poses[:, :3], atol=8e-3)
        np.testing.assert_allclose(e.poses[:, 3:6], poses[:, 3:6] * s, atol=0.05)
        d = e.depth.numpy()[inner]
        assert np.median(np.abs(d - depth0[inner] * s) / (depth0[inner] * s)) < 0.08
        assert e.pose_covars_host.shape == (n, 6, 6)
        T, out = np.eye(4), [np.eye(4)]
        for q in e.poses:
            Tf = np.eye(4)
            Tf[:3, :3], Tf[:3, 3] = _r2R(q[:3]), q[3:6]
            T = Tf @ T
            out.append(np.linalg.inv(T))
        trajs.append(np.stack(out))
    extent = float(np.linalg.norm(trajs[1][:, :3, 3], axis=1).max())
    assert ate_rmse(trajs[0], trajs[1], with_scale=True) < 0.02 * extent
    g = fused.ground
    assert g is not None and np.isfinite(g.height) and np.isfinite(g.normal).all()
