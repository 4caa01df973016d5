"""The port's application layer against the JAX package, on the CPU: the
file loaders, map checkpoints, the mono-scaled mode (its Huber fit without
scikit-learn), the cost at abs_resize_factor 0.5 and the demo CLI
(voldor_tpu_torch/demo.py).

* The three loaders on .flo / .png files at KITTI's 370x1226, resized by 0.5
  to 185x613: bitwise equal arrays (both follow the same cv2 calls).
* save_map / load_map: a map saved by either package loads in the other.
* _mono_scaled_fit on the same window, with the same pixel draw: the same
  scale (within 1e-5 relative; it is bitwise here) as the JAX package's
  scikit-learn fit. mode="mono-scaled" end to end: the bench's metric gate.
* The cost function at abs_resize_factor 0.5 (the demo's default) against
  JAX's em.compute_cost_map_tracked: rtol = atol = 1e-5.
* The demo: its flags and defaults, and one run of main() on the CPU over
  files (loader threads, loop closure, mapping, every output).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voldor_tpu.slam import checkpoint as jckpt
from voldor_tpu.slam.frame import Edge as JEdge, Frame as JFrame
from voldor_tpu.slam.system import VOLDOR_SLAM as JSLAM
from voldor_tpu.utils.flow_io import save_flow
from voldor_tpu.vo import em as jem
from voldor_tpu_torch import demo
from voldor_tpu_torch.convert import em_params_from_numpy
from voldor_tpu_torch.ops import cost as tcost
from voldor_tpu_torch.slam import checkpoint as tckpt
from voldor_tpu_torch.slam import system as tsystem
from voldor_tpu_torch.slam.frame import Edge as TEdge, Frame as TFrame
from voldor_tpu_torch.slam.huber import huber_fit
from voldor_tpu_torch.slam.system import VOLDOR_SLAM as TSLAM
from voldor_tpu_torch.utils.evaluation import ate_rmse

from synthetic import plane_depth
from test_slam import CX, CY, FX, FY, H, PLANES, W, _make_sequence
from test_torch_cost import _assert_cost_equal, _case, _jax_planes, _to_torch
from test_torch_lc import lc_scene, one_torch_thread  # noqa: F401 (a fixture)

ROOT = Path(__file__).resolve().parents[1]
USER_CONFIG = "--n_poses_to_sample 2048 --depth_rand_samples 6"
KH, KW = 370, 1226  # KITTI's input size


# --------------------------------------------------------------------------
# loaders
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kitti_files(tmp_path_factory):
    """Three flows, three BGR images and three disparities (as .flo and as
    16-bit .png) at 370x1226, from a seeded generator."""
    cv2 = pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("kitti")
    rng = np.random.default_rng(12)
    for sub in ("flow", "image", "disp_flo", "disp_png"):
        (d / sub).mkdir()
    ys, xs = np.mgrid[0:KH, 0:KW].astype(np.float32)
    for i in range(3):
        flow = np.stack([np.sin(0.01 * xs + i) * 20, np.cos(0.013 * ys - i) * 7], -1)
        flow += rng.normal(0, 0.5, flow.shape)
        save_flow(str(d / "flow" / f"{i:06d}.flo"), flow.astype(np.float32))
        img = rng.integers(0, 256, (KH, KW, 3), dtype=np.uint8)
        img[::7] = 255 - img[::7]
        cv2.imwrite(str(d / "image" / f"{i:06d}.png"), img)
        disp = (30 + 20 * np.sin(0.005 * xs + i) + rng.normal(0, 0.3, (KH, KW))).astype(np.float32)
        disp[rng.uniform(size=disp.shape) < 0.2] = 0.0  # holes
        save_flow(str(d / "disp_flo" / f"{i:06d}.flo"), np.stack([-disp, np.zeros_like(disp)], -1))
        cv2.imwrite(str(d / "disp_png" / f"{i:06d}.png"), (disp * 256).astype(np.uint16))
    return d


def _load(cls, files, disp_kind, flow_range, **kw):
    slam = cls(mode="stereo", **kw)
    slam.flow_loader(str(files / "flow"), resize=0.5, range=flow_range)
    slam.image_loader(str(files / "image"))
    slam.disp_loader(str(files / f"disp_{disp_kind}"))
    return slam


@pytest.mark.parametrize("disp_kind,flow_range", [("flo", (0, 0)), ("png", (1, 3))])
def test_loaders_match_jax(kitti_files, disp_kind, flow_range):
    j = _load(JSLAM, kitti_files, disp_kind, flow_range)
    t = _load(TSLAM, kitti_files, disp_kind, flow_range, device="cpu")
    n = 3 if flow_range == (0, 0) else 2
    assert (t.h, t.w, t.N_FRAMES) == (j.h, j.w, j.N_FRAMES) == (185, 613, n + 1)
    assert (t.flow_loader_pt, t.image_loader_pt, t.disp_loader_pt) == \
        (j.flow_loader_pt, j.image_loader_pt, j.disp_loader_pt) == (n, 3, 3)
    for name in ("flows", "images_bgri", "images_grayf", "disps"):
        a, b = getattr(t, name), getattr(j, name)
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert t.flows[0].shape == (185, 613, 2) and t.images_bgri[0].shape == (185, 613, 3)


# --------------------------------------------------------------------------
# map checkpoints
# --------------------------------------------------------------------------


def _small_map(cls, frame_cls, edge_cls, **kw):
    slam = cls(mode="mono", **kw)
    slam.set_cam_params(FX, FY, CX, CY)
    rng = np.random.default_rng(3)
    for k in range(6):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.2 * k, 0.01 * k, 0.0]
        kf = k % 2 == 0
        depth = rng.uniform(2, 9, (H, W)).astype(np.float32) if kf else None
        conf = rng.uniform(0, 1, (H, W)).astype(np.float32) if kf else None
        slam.frames.append(frame_cls(T, depth, conf, scale=1.0 + 0.1 * k, is_keyframe=kf))
        if kf:
            slam.kf_ids.append(k)
        if k:
            slam.edges.append(edge_cls(k - 1, k, rng.normal(0, 0.1, 6).astype(np.float32),
                                       np.diag(rng.uniform(1e-4, 1e-2, 6)).astype(np.float32)))
    slam.edges.append(edge_cls(0, 4, rng.normal(0, 0.1, 7).astype(np.float32),
                               np.eye(7, dtype=np.float32) * 1e-3, edge_type="falign-lc"))
    slam.lc_candidates = [(0, 2)]
    slam.fid_cur, slam.fid_cur_tmpkf, slam.fid_cur_spakf = 6, 4, 2
    slam.Twc_cur = np.linalg.inv(slam.frames[-1].Tcw).astype(np.float32)
    return slam


def _assert_same_map(a, b):
    assert len(a.frames) == len(b.frames) and a.kf_ids == b.kf_ids
    for fa, fb in zip(a.frames, b.frames):
        np.testing.assert_array_equal(fa.Tcw, fb.Tcw)
        # the format keeps scales in float32
        assert (np.float32(fa.scale), fa.is_keyframe) == (np.float32(fb.scale), fb.is_keyframe)
        for name in ("depth", "depth_conf"):
            x, y = getattr(fa, name), getattr(fb, name)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)
    assert [(e.fid1, e.fid2, e.edge_type) for e in a.edges] == \
        [(e.fid1, e.fid2, e.edge_type) for e in b.edges]
    for ea, eb in zip(a.edges, b.edges):
        np.testing.assert_array_equal(ea.pose, eb.pose)
        np.testing.assert_array_equal(ea.pose_covar, eb.pose_covar)
    assert a.lc_candidates == b.lc_candidates
    assert (a.fid_cur, a.fid_cur_tmpkf, a.fid_cur_spakf) == (b.fid_cur, b.fid_cur_tmpkf, b.fid_cur_spakf)
    np.testing.assert_array_equal(a.Twc_cur, b.Twc_cur)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_map_checkpoint_loads_across_packages(tmp_path, direction):
    t = _small_map(TSLAM, TFrame, TEdge, device="cpu")
    # a keyframe whose maps are still device tensors saves its host copy
    f2 = t.frames[2]
    f2.set_window_maps(torch.as_tensor(f2.depth), torch.as_tensor(f2.depth_conf))
    f2.depth = f2.depth_conf = None
    j = _small_map(JSLAM, JFrame, JEdge)
    path = str(tmp_path / "map.npz")
    if direction == "port_to_jax":
        src, save, dst, load = t, tckpt.save_map, JSLAM(mode="mono"), jckpt.load_map
    else:
        src, save, dst, load = j, jckpt.save_map, TSLAM(mode="mono", device="cpu"), tckpt.load_map
    save(src, path)
    load(dst, path)
    _assert_same_map(dst, src)
    _assert_same_map(dst, j)
    # the JAX package asserts, the port raises ValueError
    other, err = ((JSLAM(mode="stereo"), AssertionError) if isinstance(dst, JSLAM)
                  else (TSLAM(mode="stereo", device="cpu"), ValueError))
    with pytest.raises(err, match="mode"):
        load(other, path)


# --------------------------------------------------------------------------
# mono-scaled
# --------------------------------------------------------------------------


def _scaled_window(h, w, seed):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(2.0, 20.0, (h, w)).astype(np.float32)
    conf = rng.uniform(0.0, 1.0, (h, w)).astype(np.float32)
    bf = 0.25 * (FX + FY)
    disp = (bf / (depth * 1.7) + rng.normal(0, 0.05, (h, w))).astype(np.float32)
    disp[rng.uniform(size=(h, w)) < 0.2] = 0.0  # holes
    out = rng.uniform(size=(h, w)) < 0.1
    disp[out] = rng.uniform(0, 60, int(out.sum()))  # outliers
    poses = rng.normal(0, 0.1, (3, 6)).astype(np.float32)
    covar = np.tile(np.diag(rng.uniform(1e-4, 1e-2, 6)).astype(np.float32), (3, 1, 1))
    return dict(depth=depth, depth_conf=conf, poses=poses, poses_covar=covar), disp


@pytest.mark.parametrize("case", ["subsample", "all_pixels", "too_few"])
def test_mono_scaled_fit_matches_jax(case):
    """The Huber scale fit on one window in both packages, the JAX side
    through scikit-learn, the same pixel draw on both sides (np.random's
    global state seeded there, a RandomState of that seed here)."""
    pytest.importorskip("sklearn")
    h, w = (160, 120) if case == "subsample" else (40, 50)
    ret, disp = _scaled_window(h, w, 4)
    if case == "too_few":
        ret["depth_conf"][:] = 0.0
        ret["depth_conf"][0, :9] = 1.0
    rets = {}
    for name, cls, kw in (("jax", JSLAM, {}), ("port", TSLAM, {"device": "cpu"})):
        slam = cls(mode="mono-scaled", **kw)
        slam.set_cam_params(FX, FY, CX, CY)
        slam.disps = [disp]
        r = {k: v.copy() for k, v in ret.items()}
        if name == "jax":
            np.random.seed(7)
        else:
            slam.depth_scaling_rng = np.random.RandomState(7)
        slam._mono_scaled_fit(r)
        rets[name] = r
    j, t = rets["jax"], rets["port"]
    scale_j = float(j["depth"][0, 0] / ret["depth"][0, 0])
    scale_t = float(t["depth"][0, 0] / ret["depth"][0, 0])
    np.testing.assert_allclose(scale_t, scale_j, rtol=1e-5)
    for k in ret:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-5, atol=0, err_msg=k)
    if case == "too_few":
        assert scale_t == 1.0
    else:
        assert abs(scale_t - 1.7) < 0.05  # the fit finds the true scale


def test_huber_coef_is_the_regressors():
    sklearn = pytest.importorskip("sklearn.linear_model")
    rng = np.random.default_rng(9)
    src = rng.uniform(1, 50, 3000).astype(np.float32)
    dst = (0.6 * src + rng.normal(0, 0.4, 3000)).astype(np.float32)
    dst[:400] = rng.uniform(0, 60, 400)
    ref = sklearn.HuberRegressor(fit_intercept=False).fit(src.reshape(-1, 1), dst).coef_[0]
    coef, iters = huber_fit(src, dst)
    assert coef == ref and iters > 0


def test_port_slam_mono_scaled_metric_trajectory(one_torch_thread):
    """mode="mono-scaled" over the 8-flow test_slam scene with disparity bf /
    depth: every window's maps rescaled on the host, and the trajectory
    passes the bench's metric gate for this mode (bench.py:204, ATE with no
    scale alignment < 0.05 x extent)."""
    pytest.importorskip("scipy")
    _, flows, _, Ts = _make_sequence(8)
    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
    bf = 0.5 * FX
    slam = TSLAM(mode="mono-scaled", device="cpu")
    slam.use_image_info = False
    slam.voldor_user_config = USER_CONFIG
    slam.set_cam_params(FX, FY, CX, CY, basefocal=bf)
    slam.disps = [(bf / plane_depth(K, T[:3, :3], T[:3, 3], PLANES, H, W)).astype(np.float32)
                  for T in Ts[:-1]]
    slam.disp_loader_pt = len(slam.disps)
    slam.flows = [flows[i] for i in range(flows.shape[0])]
    slam.N_FRAMES = flows.shape[0] + 1
    slam.h, slam.w = H, W
    slam.flow_loader_pt = flows.shape[0]
    while slam.process_vo():
        pass
    assert len(slam.frames) == slam.N_FRAMES
    kf = slam.frames[slam.kf_ids[0]]
    assert kf.depth_dev is None and kf.depth is not None  # host maps, rescaled
    gt = np.linalg.inv(Ts)
    extent = float(np.linalg.norm(gt[:, :3, 3] - gt[0, :3, 3], axis=1).max())
    est = np.stack([f.Tcw for f in slam.frames]).astype(np.float64)
    assert ate_rmse(est, gt, with_scale=False) < 0.05 * extent


# --------------------------------------------------------------------------
# the cost at abs_resize_factor 0.5
# --------------------------------------------------------------------------


@pytest.mark.parametrize("active_n,D", [(4, 0), (4, 2), (2, 1)])
def test_cost_at_abs_resize_half_matches_jax(active_n, D):
    c = _case(32, 128, 4, disparity=D == 2)
    c["p"] = c["p"]._replace(abs_resize_factor=np.float32(0.5))
    with jax.disable_jit():
        rig, track, tinb, ps = _jax_planes(c, active_n, D)
        ref = jax.vmap(
            lambda d: jem.compute_cost_map_tracked(
                d, track, tinb, rig, jnp.asarray(c["Rs"]), jnp.asarray(c["ts"]), ps,
                jnp.int32(active_n), c["p"],
            )
        )(jnp.asarray(c["cands"]))
        at_one = jax.vmap(
            lambda d: jem.compute_cost_map_tracked(
                d, track, tinb, rig, jnp.asarray(c["Rs"]), jnp.asarray(c["ts"]), ps,
                jnp.int32(active_n), c["p"]._replace(abs_resize_factor=np.float32(1.0)),
            )
        )(jnp.asarray(c["cands"]))
    trig, ttrack, ttinb, tRs, tts, tps = _to_torch(rig, track, tinb, ps, c)
    p = em_params_from_numpy(c["p"])
    assert float(p.abs_resize_factor) == 0.5
    got = tcost.cost_map_score(torch.as_tensor(c["cands"]), ttrack, ttinb, trig, tRs, tts,
                               active_n, p, prior_samples=tps)
    _assert_cost_equal(got, ref)
    fin = np.isfinite(np.asarray(ref))
    assert not np.allclose(np.asarray(ref)[fin], np.asarray(at_one)[fin])  # the factor matters


# --------------------------------------------------------------------------
# the demo CLI
# --------------------------------------------------------------------------


def test_demo_flags_and_defaults(monkeypatch):
    base = ["--mode", "mono", "--flow_dir", "f", "--fx", "700", "--fy", "700",
            "--cx", "613", "--cy", "185"]
    opt = demo.parse_args(base)
    assert (opt.resize, opt.abs_resize, opt.bf) == (0.5, 0.5, 0)
    assert opt.enable_loop_closure is None and not opt.enable_mapping and opt.device is None
    opt = demo.parse_args(base + ["--resize", "0.25", "--enable_loop_closure"])
    assert (opt.resize, opt.abs_resize, opt.enable_loop_closure) == (0.25, 0.25, "builtin")
    opt = demo.parse_args(base + ["--abs_resize", "1", "--enable_loop_closure", "voc.txt.gz"])
    assert (opt.resize, opt.abs_resize, opt.enable_loop_closure) == (0.5, 1.0, "voc.txt.gz")
    # --debug_dir reaches the SLAM object (tests/test_torch_debug.py runs
    # the dumps); the probe stops main() at the flow loader
    seen = {}

    class _Stop(Exception):
        pass

    class _Probe:
        def __init__(self, mode, device=None):
            seen["mode"], seen["device"] = mode, device

        def set_cam_params(self, *a, **k):
            pass

        def flow_loader(self, **k):
            pass

        def flow_loader_sync(self, *a, **k):
            seen["debug_dir"] = self.debug_dir
            raise _Stop

    with monkeypatch.context() as m:
        m.setattr(tsystem, "VOLDOR_SLAM", _Probe)
        with pytest.raises(_Stop):
            demo.main(base + ["--debug_dir", "d", "--device", "cpu"])
    assert seen == {"mode": "mono", "device": "cpu", "debug_dir": "d"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):  # no silent CPU run
        demo.main(base)
    out = subprocess.run([sys.executable, "-m", "voldor_tpu_torch.demo", "--help"],
                         capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0 and "--enable_loop_closure" in out.stdout


class _FastSLAM(TSLAM):
    """The port's VOLDOR_SLAM with the tests' lighter pose sampling appended
    to whatever user config the demo sets."""

    @property
    def voldor_user_config(self):
        return self._user_config + " " + USER_CONFIG

    @voldor_user_config.setter
    def voldor_user_config(self, v):
        self._user_config = v


def test_demo_runs_on_cpu(tmp_path, monkeypatch, one_torch_thread):
    """main() over files written at twice the working size (the default
    --resize 0.5 and abs_resize 0.5): the loader threads, loop closure,
    mapping and every output; the poses file passes the Sim3 gate and the
    saved map loads back into both packages with the same poses."""
    cv2 = pytest.importorskip("cv2")
    flows, bgr, _, Ts, K = lc_scene(256, 384, n_flows=8)
    (tmp_path / "flow").mkdir()
    (tmp_path / "img").mkdir()
    for i, f in enumerate(flows):
        save_flow(str(tmp_path / "flow" / f"{i:06d}.flo"), f)
    for i, im in enumerate(bgr):
        cv2.imwrite(str(tmp_path / "img" / f"{i:06d}.png"), im)
    monkeypatch.setattr(tsystem, "VOLDOR_SLAM", _FastSLAM)
    out = {k: str(tmp_path / k) for k in ("poses.txt", "map.npz", "depths", "cloud.ply", "m.jsonl")}
    slam = demo.main([
        "--mode", "mono", "--flow_dir", str(tmp_path / "flow"), "--img_dir", str(tmp_path / "img"),
        "--fx", str(K[0, 0]), "--fy", str(K[1, 1]), "--cx", str(K[0, 2]), "--cy", str(K[1, 2]),
        "--enable_mapping", "--enable_loop_closure", "--viewer", "--device", "cpu",
        "--save_poses", out["poses.txt"], "--save_map", out["map.npz"],
        "--save_depths", out["depths"], "--save_ply", out["cloud.ply"], "--metrics", out["m.jsonl"],
    ])
    assert (slam.h, slam.w, slam.N_FRAMES) == (128, 192, len(Ts))
    assert slam._engine_config().abs_resize_factor == 0.5
    lines = Path(out["poses.txt"]).read_text().strip().split("\n")
    assert len(lines) == len(Ts)
    est = np.tile(np.eye(4), (len(lines), 1, 1))
    est[:, :3, :4] = np.array([ln.split() for ln in lines], np.float64).reshape(-1, 3, 4)
    gt = np.linalg.inv(Ts)
    extent = float(np.linalg.norm(gt[:, :3, 3] - gt[0, :3, 3], axis=1).max())
    assert ate_rmse(est, gt, with_scale=True) < 0.02 * extent
    for cls, kw in ((TSLAM, {"device": "cpu"}), (JSLAM, {})):
        back = cls(mode="mono", **kw)
        (tckpt if cls is TSLAM else jckpt).load_map(back, out["map.npz"])
        np.testing.assert_array_equal(np.stack([f.Tcw for f in back.frames]),
                                      np.stack([f.Tcw for f in slam.frames]))
    assert len(list(Path(out["depths"]).glob("*_depth.npy"))) == len(slam.kf_ids)
    head = Path(out["cloud.ply"]).read_text().split("end_header\n")[0]
    assert int(head.split("element vertex ")[1].split()[0]) > 0
    events = [json.loads(x)["event"] for x in Path(out["m.jsonl"]).read_text().splitlines()]
    assert "vo_window" in events and "pgo" in events
    assert slam._use_loop_closure and len(slam.retriever) == len(slam.kf_ids)
