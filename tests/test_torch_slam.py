"""The port's SLAM VO layer (voldor_tpu_torch/slam/system.py and the VO entry
seam under it) against the JAX package's, on the CPU.

* Orchestrator parity: both VOLDOR_SLAMs drive the same scripted fake
  window (tracking loss, covis dips, spakf gate, a pipeline flush) over 20
  flows, pipelined and not; the maps, keyframes and every dispatch input
  agree (atol 1e-6).
* Stacking parity: the prior and flow stacking is bitwise equal to
  voldor_tpu.vo.engine._stack_maps / _stack_flows.
* Disparity init: the stereo prior slot of VoldorEngine.init is bitwise
  equal to the JAX package's, with no prior-fusion round.
* End to end on the CPU: the port's VOLDOR_SLAM over tests/test_slam.py's
  8-flow scene, mono (the gates of test_slam_mono_vo_trajectory) and
  stereo (a metric ATE gate, 0.02 x extent); the saved outputs.
* Without a card, device=None raises instead of running on the CPU.
"""

import json
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voldor_tpu.config import VoldorConfig as JConfig
from voldor_tpu.slam.system import VOLDOR_SLAM as JSLAM
from voldor_tpu.vo import engine as jengine
from voldor_tpu_torch.config import VoldorConfig as TConfig
from voldor_tpu_torch.ops import cost as tcost
from voldor_tpu_torch.slam.slam_utils import T6_to_T44, eval_covisibility
from voldor_tpu_torch.slam.system import VOLDOR_SLAM as TSLAM
from voldor_tpu_torch.utils.evaluation import ate_rmse
from voldor_tpu_torch.vo import api as tapi
from voldor_tpu_torch.vo import engine as tengine

from synthetic import plane_depth
from test_slam import CX, CY, FX, FY, H, PLANES, W, _make_sequence

USER_CONFIG = "--n_poses_to_sample 2048 --depth_rand_samples 6"


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


# --------------------------------------------------------------------------
# (a) orchestrator parity on a scripted fake window
# --------------------------------------------------------------------------

N_SCRIPT = 20
SH, SW = 8, 12  # map size of the fake window (its maps only mark their fid)
LOST = {11}  # windows at these fids register nothing
PARTIAL = {2: 3, 15: 2}  # fid -> n_registered below the window size


class _FakeWindow:
    def __init__(self, res, depth, conf):
        self._res = res
        self.depth_dev = depth
        self.conf_dev = conf
        self.host_copies_started = False

    def collect(self):
        return {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in self._res.items()}

    def start_host_copies(self):
        self.host_copies_started = True


def _scripted_result(inputs):
    """The fake window's answer, a function of its start fid only (a
    flushed window re-dispatched at the same fid answers the same)."""
    fid = inputs["fid"]
    n_true = len(inputs["flows"])
    rng = np.random.default_rng(1000 + fid)
    n_reg = 0 if fid in LOST else min(n_true, PARTIAL.get(fid, n_true))
    poses = np.zeros((n_reg, 6), np.float32)
    poses[:, :3] = rng.normal(0, 0.01, (n_reg, 3))
    poses[:, 3:6] = [0.3, 0.01, 0.1] + rng.normal(0, 0.02, (n_reg, 3))
    covar = np.zeros((n_reg, 6, 6), np.float32)
    for i in range(n_reg):
        covar[i] = np.diag(rng.uniform(1e-4, 1e-2, 6))
    res = {"n_registered": n_reg, "poses": poses, "poses_covar": covar,
           "covis": rng.uniform(0.7, 1.0, n_true).astype(np.float32)}
    if "spakf" in inputs["covis_spec"]:
        res["spakf_covis"] = rng.uniform(0.65, 1.0, n_true).astype(np.float32)
    depth = np.full((SH, SW), 1.0 + fid, np.float32)
    conf = np.full((SH, SW), 0.5 + 0.01 * fid, np.float32)
    return res, depth, conf


def _map_value(x):
    """First element of a prior map entry (numpy, tensor, jax array or
    DeviceMap) times its deferred scale."""
    scale = 1.0
    if hasattr(x, "scale") and hasattr(x, "arr"):
        x, scale = x.arr, x.scale
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return float(np.asarray(x).reshape(-1)[0]) * scale


def _record(inputs):
    spec = inputs["covis_spec"]
    spa = spec.get("spakf")
    return dict(
        fid=inputs["fid"],
        n_flows=len(inputs["flows"]),
        prior_poses=inputs["depth_prior_poses"],
        prior_values=[_map_value(x) for x in inputs["depth_priors"] or []],
        pconf_values=[_map_value(x) for x in inputs["depth_prior_pconfs"] or []],
        poses_init=inputs["poses_init"],
        conf_thresh=spec["conf_thresh"],
        spakf=None if spa is None else (_map_value(spa[0]), _map_value(spa[1]), spa[2],
                                        np.asarray(spa[3])),
    )


def _run_scripted(slam, to_dev, metrics_path):
    flows = np.zeros((N_SCRIPT, SH, SW, 2), np.float32)
    slam.use_image_info = False
    slam.set_cam_params(20.0, 20.0, SW / 2, SH / 2)
    slam.flows = [flows[i] for i in range(N_SCRIPT)]
    slam.N_FRAMES = N_SCRIPT + 1
    slam.h, slam.w = SH, SW
    slam.flow_loader_pt = N_SCRIPT
    slam.metrics.open(str(metrics_path))
    dispatched, states = [], []

    def fake_dispatch(inputs):
        dispatched.append(_record(inputs))
        res, depth, conf = _scripted_result(inputs)
        return _FakeWindow(res, to_dev(depth), to_dev(conf))

    slam._vo_dispatch = fake_dispatch
    calls = 0
    while slam.process_vo():
        calls += 1
        if calls == 4:
            slam._map_version += 1  # a map write-back: flushes the pending window
        states.append((slam.fid_cur, slam.fid_cur_tmpkf, slam.fid_cur_spakf,
                       len(slam.frames), list(slam.kf_ids)))
    slam.metrics.close()
    events = []
    for line in metrics_path.read_text().splitlines():
        e = json.loads(line)
        e.pop("t")
        e.pop("window_s", None)
        events.append(e)
    return dispatched, states, events


def _assert_same(a, b, path="root"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif a is None or isinstance(a, (str, int)):
        assert a == b, path
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=0, atol=1e-6, err_msg=path)


def test_orchestrator_matches_jax_on_scripted_windows(tmp_path):
    jslam = JSLAM(mode="mono")
    tslam = TSLAM(mode="mono", device="cpu")
    j_disp, j_states, j_events = _run_scripted(jslam, lambda a: a, tmp_path / "j.jsonl")
    t_disp, t_states, t_events = _run_scripted(tslam, torch.as_tensor, tmp_path / "t.jsonl")

    # the script reached every branch it is meant to
    kinds = [e["event"] for e in j_events]
    assert "tracking_lost" in kinds and "vo_pipeline_flush" in kinds
    steps = [(e["vo_step"], e["n_registered"]) for e in j_events if e["event"] == "vo_window"]
    assert any(s < n for s, n in steps)  # a covis dip cut a window short
    assert len(jslam.kf_ids) >= 4 and any(d["spakf"] is not None for d in j_disp)

    assert j_states == t_states
    assert j_events == t_events
    _assert_same(j_disp, t_disp, "dispatch")
    assert len(jslam.frames) == len(tslam.frames) == N_SCRIPT + 1
    for fj, ft in zip(jslam.frames, tslam.frames):
        np.testing.assert_allclose(ft.Tcw, fj.Tcw, rtol=0, atol=1e-6)
        assert ft.is_keyframe == fj.is_keyframe
    assert jslam.kf_ids == tslam.kf_ids
    assert (jslam.fid_cur_tmpkf, jslam.fid_cur_spakf) == (tslam.fid_cur_tmpkf, tslam.fid_cur_spakf)
    assert len(jslam.edges) == len(tslam.edges)
    for ej, et in zip(jslam.edges, tslam.edges):
        assert (et.fid1, et.fid2, et.edge_type) == (ej.fid1, ej.fid2, ej.edge_type)
        np.testing.assert_allclose(et.pose, ej.pose, rtol=0, atol=1e-6)
        np.testing.assert_allclose(et.pose_covar, ej.pose_covar, rtol=0, atol=1e-6)
    # keyframes keep their maps on the host; other frames dropped theirs
    for fid in tslam.kf_ids:
        np.testing.assert_array_equal(tslam.frames[fid].depth, jslam.frames[fid].depth)


def test_orchestrator_matches_jax_without_pipeline(tmp_path):
    """vo_pipeline=False: each window is dispatched inside the call that
    consumes it, so a map write-back flushes nothing; the decisions and the
    dispatch inputs still match the JAX orchestrator's and the pipelined
    run's."""
    runs = {}
    for name, slam, to_dev in (("jax", JSLAM(mode="mono"), lambda a: a),
                               ("port", TSLAM(mode="mono", device="cpu"), torch.as_tensor),
                               ("port_pipelined", TSLAM(mode="mono", device="cpu"), torch.as_tensor)):
        slam.vo_pipeline = name == "port_pipelined"
        runs[name] = (slam, *_run_scripted(slam, to_dev, tmp_path / f"{name}.jsonl"))
    (jslam, j_disp, j_states, j_events), (tslam, t_disp, t_states, t_events) = runs["jax"], runs["port"]
    assert not jslam.vo_pipeline and not tslam.vo_pipeline
    assert "vo_pipeline_flush" not in [e["event"] for e in t_events]
    assert j_states == t_states
    assert j_events == t_events
    _assert_same(j_disp, t_disp, "dispatch")
    assert jslam.kf_ids == tslam.kf_ids
    for fj, ft in zip(jslam.frames, tslam.frames):
        np.testing.assert_allclose(ft.Tcw, fj.Tcw, rtol=0, atol=1e-6)
    # the pipeline changes when a window is dispatched, not what it decides
    _, p_disp, p_states, p_events = runs["port_pipelined"]
    assert p_states == t_states
    assert [e for e in p_events if e["event"] != "vo_pipeline_flush"] == t_events
    assert len(p_disp) == len(t_disp) + 1  # the flushed window, dispatched twice


# --------------------------------------------------------------------------
# (b) stacking parity
# --------------------------------------------------------------------------


def _maps(rng, n, h=9, w=13):
    # a wide range, so the bf16 / f16 roundings differ from the identity
    return [(rng.standard_normal((h, w)) * 10.0 ** rng.integers(-3, 4, (h, w))).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("compress", ["bf16", "f16", None])
@pytest.mark.parametrize("kind", ["host", "mixed", "device"])
def test_stack_maps_bitwise(kind, compress):
    rng = np.random.default_rng(17)
    maps = _maps(rng, 3)
    scales = [1.0, 0.731, 2.9]
    jl, tl = [], []
    for i, m in enumerate(maps):
        if kind == "host" or (kind == "mixed" and i == 0):
            jl.append(m)
            tl.append(m)
        elif i == 1 and kind == "mixed":
            jl.append(jnp.asarray(m))
            tl.append(torch.as_tensor(m))
        else:
            jl.append(jengine.DeviceMap(jnp.asarray(m), scales[i]))
            tl.append(tengine.DeviceMap(torch.as_tensor(m), scales[i]))
    j = jengine._stack_maps(jl, compress)
    t = tengine._stack_maps(tl, compress, torch.device("cpu"))
    assert t.dtype == torch.float32 and tuple(t.shape) == (3, 9, 13)
    np.testing.assert_array_equal(_bits(t.numpy()), _bits(j))


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("kind", ["host", "mixed"])
def test_stack_flows_bitwise(kind, compress):
    rng = np.random.default_rng(23)
    flows = [np.stack(_maps(rng, 2), -1) for _ in range(4)]
    jl, tl = list(flows), list(flows)
    if kind == "mixed":
        # the upload-ahead cache's entries: f16 when the transfer dtype is
        # float16, f32 otherwise, beside host numpy
        dt = np.float16 if compress else np.float32
        for i in (1, 3):
            jl[i] = jnp.asarray(flows[i].astype(dt))
            tl[i] = torch.as_tensor(flows[i].astype(dt))
        tl[2] = torch.as_tensor(flows[2])  # an f32 tensor among f16 ones
        jl[2] = jnp.asarray(flows[2])
    j = jengine._stack_flows(jl, compress)
    t = tengine._stack_flows(tl, compress, torch.device("cpu"))
    assert t.dtype == torch.float32 and tuple(t.shape) == (4, 9, 13, 2)
    np.testing.assert_array_equal(_bits(t.numpy()), _bits(j))


# --------------------------------------------------------------------------
# (c) the disparity prior of init
# --------------------------------------------------------------------------

STEREO_CONFIG = "--silent --meanshift_kernel_var 0.1 --disp_delta 1 --delta 0.2 --max_iters 4"


@pytest.mark.parametrize("transfer", ["float16", "float32"])
@pytest.mark.parametrize("n_kf_priors", [0, 2])
def test_disparity_init_matches_jax(transfer, n_kf_priors):
    poses, flows, depth0, Ts = _make_sequence(3)
    bf = 0.5 * FX
    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
    disp = (bf / depth0).astype(np.float32)
    disp[::7, ::5] = 0.0  # holes: the prior clamps the disparity at 1e-12
    rng = np.random.default_rng(31)
    pconf = rng.uniform(0.2, 1.0, (H, W)).astype(np.float32)
    kw = {}
    if n_kf_priors:
        depth1 = plane_depth(K, Ts[1][:3, :3], Ts[1][:3, 3], PLANES, H, W)
        kw = dict(depth_priors=[depth0 * 1.02, depth1],
                  depth_prior_pconfs=[pconf, np.ones((H, W), np.float32)],
                  depth_prior_poses=np.stack([np.zeros(6, np.float32), poses[0]]))
    config = f"{STEREO_CONFIG} --transfer_dtype {transfer}"
    jcfg = JConfig(fx=FX, fy=FY, cx=CX, cy=CY, basefocal=bf)
    jcfg.read_config(config)
    tcfg = TConfig(fx=FX, fy=FY, cx=CX, cy=CY, basefocal=bf)
    tcfg.read_config(config)
    je = jengine.VoldorEngine(jcfg).init(flows, disparity=disp, disparity_pconf=pconf, **kw)
    te = tengine.VoldorEngine(tcfg, device="cpu").init(flows, disparity=disp,
                                                       disparity_pconf=pconf, **kw)
    D = 1 + n_kf_priors
    assert te.has_disparity and je.has_disparity and te.n_depth_priors == je.n_depth_priors == D
    for name in ("priors", "dp_pconfs", "dp_confs", "dp_poses6", "depth", "flows"):
        np.testing.assert_array_equal(_bits(getattr(te, name).numpy()),
                                      _bits(getattr(je, name)), err_msg=name)
    # no prior-fusion round: the depth is the disparity slot, confidences 1
    np.testing.assert_array_equal(te.depth.numpy(), te.priors[0].numpy())
    assert bool((te.dp_confs == 1).all())
    assert te._params().disp_delta == float(je._params().disp_delta) == 1.0


def test_cost_kernel_holds_stereo_priors():
    """A stereo window feeds the cost kernel the disparity slot plus up to
    two keyframe priors: the kernel's bound (COST_MAX_D) and the wrapper's
    agree and hold three."""
    src = (Path(tcost.__file__).resolve().parents[1] / "csrc" / "cost_kernel.cu").read_text()
    m = re.search(r"#define COST_MAX_D (\d+)", src)
    assert m is not None and int(m.group(1)) == tcost.MAX_D >= 3


# --------------------------------------------------------------------------
# (d)-(f) end to end on the CPU
# --------------------------------------------------------------------------


def _port_slam(mode, flows, Ts):
    slam = TSLAM(mode=mode, device="cpu")
    slam.use_image_info = False
    slam.voldor_user_config = USER_CONFIG
    if mode == "stereo":
        bf = 0.5 * FX
        K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
        slam.set_cam_params(FX, FY, CX, CY, basefocal=bf)
        slam.disps = [(bf / plane_depth(K, Ts[k][:3, :3], Ts[k][:3, 3], PLANES, H, W))
                      .astype(np.float32) for k in range(flows.shape[0])]
        slam.disp_loader_pt = len(slam.disps)
    else:
        slam.set_cam_params(FX, FY, CX, CY)
    slam.flows = [flows[i] for i in range(flows.shape[0])]
    slam.N_FRAMES = flows.shape[0] + 1
    slam.h, slam.w = H, W
    slam.flow_loader_pt = flows.shape[0]
    while slam.process_vo():
        pass
    return slam


@pytest.fixture(scope="module")
def sequence():
    return _make_sequence(8)


@pytest.fixture(scope="module")
def mono_slam(sequence):
    poses, flows, depth0, Ts = sequence
    return _port_slam("mono", flows, Ts)


def _check_trajectory(slam, Ts):
    """The assertions of tests/test_slam.py:test_slam_mono_vo_trajectory."""
    assert len(slam.frames) == slam.N_FRAMES
    assert len(slam.kf_ids) >= 1
    assert slam.frames[slam.kf_ids[0]].depth is not None
    T_last_est = slam.frames[int(slam.N_FRAMES) - 1].Tcw
    T_last_true = np.linalg.inv(Ts[-1])
    R_err = T_last_est[:3, :3] @ T_last_true[:3, :3].T
    ang = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    assert ang < 2.0
    t_est, t_true = T_last_est[:3, 3], T_last_true[:3, 3]
    cos = np.dot(t_est, t_true) / (np.linalg.norm(t_est) * np.linalg.norm(t_true) + 1e-12)
    assert cos > 0.995
    assert len(slam.edges) == slam.N_FRAMES - 1
    assert all(np.all(np.isfinite(e.pose_covar)) for e in slam.edges)


def test_port_slam_mono_vo_trajectory(sequence, mono_slam):
    _check_trajectory(mono_slam, sequence[3])
    for f in mono_slam.frames:
        assert f.depth_dev is None or f.depth_dev.device.type == "cpu"


def test_port_slam_stereo_metric_trajectory(sequence):
    poses, flows, depth0, Ts = sequence
    slam = _port_slam("stereo", flows, Ts)
    _check_trajectory(slam, Ts)
    gt = np.linalg.inv(Ts)
    extent = float(np.linalg.norm(gt[:, :3, 3] - gt[0, :3, 3], axis=1).max())
    est = np.stack([f.Tcw for f in slam.frames]).astype(np.float64)
    assert ate_rmse(est, gt, with_scale=False) < 0.02 * extent


def test_port_save_poses_formats(mono_slam, tmp_path):
    slam = mono_slam
    p_kitti = tmp_path / "poses_kitti.txt"
    slam.save_poses(str(p_kitti), format="KITTI")
    lines = p_kitti.read_text().strip().split("\n")
    assert len(lines) == int(slam.N_FRAMES)
    assert len(lines[0].split()) == 12
    np.testing.assert_allclose(np.array(lines[-1].split(), np.float64).reshape(3, 4),
                               slam.frames[-1].Tcw[:3, :4], rtol=1e-6)

    p_ta = tmp_path / "poses_ta.txt"
    slam.save_poses(str(p_ta), format="TartanAir")
    lines = p_ta.read_text().strip().split("\n")
    assert len(lines) == int(slam.N_FRAMES)
    assert len(lines[0].split()) == 7

    d = tmp_path / "depths"
    slam.save_depth_maps(str(d))
    assert len(list(d.glob("*_depth.npy"))) == len(slam.kf_ids)
    assert len(list(d.glob("*_depth_conf.npy"))) == len(slam.kf_ids)
    kf = slam.kf_ids[0]
    np.testing.assert_array_equal(np.load(d / f"{str(kf).zfill(6)}_depth.npy"),
                                  slam.frames[kf].get_scaled_depth())


def test_dispatch_covis_matches_host(sequence):
    """voldor_dispatch(covis_spec=...) on the CPU: the window's covis and
    spakf scores agree with the host gate on its own output maps."""
    poses, flows, depth0, Ts = sequence
    bf = 0.5 * FX
    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
    M = np.eye(4, dtype=np.float32)
    M[:3, 3] = [-0.3, 0.0, -0.1]
    kf_conf = np.full((H, W), 0.5, np.float32)
    spec = {"conf_thresh": 0.1, "spakf": (depth0 * 1.3, kf_conf, 0.77, M)}
    win = tapi.voldor_dispatch(
        flows[:5], FX, FY, CX, CY, basefocal=bf,
        config=f"--silent --pose_sample_min_depth {bf / 200} --pose_sample_max_depth {bf} "
               + USER_CONFIG,
        pad_window_to=5, covis_spec=spec, host_copies=False, device="cpu",
    )
    res = win.collect()
    depth, conf = win.depth_host(), win.conf_host()
    assert res["n_registered"] == 5 and res["covis"].shape == res["spakf_covis"].shape == (5,)
    T = np.eye(4)
    for i, p in enumerate(win.engine.poses6.numpy()):
        T = T6_to_T44(p).astype(np.float64) @ T
        host = eval_covisibility(depth, T, K, conf > 0.1)
        host_kf = eval_covisibility(depth0 * 1.3 * np.float32(0.77), T @ M.astype(np.float64),
                                    K, kf_conf > 0.1)
        assert abs(res["covis"][i] - host) < 1e-5, (i, res["covis"][i], host)
        assert abs(res["spakf_covis"][i] - host_kf) < 1e-5, (i, res["spakf_covis"][i], host_kf)


# --------------------------------------------------------------------------
# (g) no silent CPU default; what still raises
# --------------------------------------------------------------------------


def test_device_none_raises_without_a_card(monkeypatch, sequence):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flows = sequence[1][:2]
    cfg = TConfig(fx=FX, fy=FY, cx=CX, cy=CY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSLAM(mode="mono")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.VoldorEngine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.voldor_dispatch(flows, FX, FY, CX, CY, config="--silent")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.voldor(flows, FX, FY, CX, CY, config="--silent")
    assert tengine.VoldorEngine(cfg, device="cpu").device.type == "cpu"


def test_port_slam_rejects_engine_resize_factor(sequence):
    """An engine-side --resize_factor is not ported: the window's init
    reports it, whatever the SLAM layer hands it."""
    slam = TSLAM(mode="mono", device="cpu")
    slam.set_cam_params(FX, FY, CX, CY)
    slam.voldor_user_config = USER_CONFIG + " --resize_factor 0.5"
    slam.flows = [f for f in sequence[1]]
    slam.N_FRAMES = len(slam.flows) + 1
    slam.flow_loader_pt = len(slam.flows)
    with pytest.raises(NotImplementedError, match="resize_factor"):
        slam.process_vo()


@pytest.mark.parametrize("call", [
    "mono-scaled", "solve_pgo", "establish_local_links", "establish_links_batch",
    "establish_lc_links", "mapping_thread", "enable_loop_closure", "flow_loader",
    "image_loader", "disp_loader",
])
def test_unported_entry_points_raise(call):
    if call == "mono-scaled":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TSLAM(mode=call, device="cpu")
        return
    slam = TSLAM(mode="mono", device="cpu")
    args = {"solve_pgo": (), "mapping_thread": (), "enable_loop_closure": (),
            "establish_links_batch": ([(0, 1)],)}.get(call, ("x",))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(slam, call)(*args)
