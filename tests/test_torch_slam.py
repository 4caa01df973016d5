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
* The mapping half against the JAX VOLDOR_SLAM: establish_links_batch
  (local and lc) and solve_pgo on identical injected keyframes, the
  mapping thread's scheduling with falign_pairs and pgo stubbed, and
  vo_thread + mapping_thread end to end at 72x96. Tolerances at each test.
"""

import json
import re
import sys
import threading
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voldor_tpu.config import VoldorConfig as JConfig
from voldor_tpu.falign import api as jfalign_api
from voldor_tpu.pgo import api as jpgo_api
from voldor_tpu.slam.frame import Edge as JEdge, Frame as JFrame
from voldor_tpu.slam.system import VOLDOR_SLAM as JSLAM
from voldor_tpu.vo import engine as jengine
from voldor_tpu_torch.config import VoldorConfig as TConfig
from voldor_tpu_torch.falign import api as tfalign_api
from voldor_tpu_torch.ops import cost as tcost
from voldor_tpu_torch.pgo import api as tpgo_api
from voldor_tpu_torch.slam.frame import Edge as TEdge, Frame as TFrame
from voldor_tpu_torch.slam.slam_utils import T6_to_T44, T44_to_T6, eval_covisibility
from voldor_tpu_torch.slam.system import VOLDOR_SLAM as TSLAM
from voldor_tpu_torch.utils.evaluation import ate_rmse
from voldor_tpu_torch.vo import api as tapi
from voldor_tpu_torch.vo import engine as tengine

from synthetic import plane_depth
from test_slam import CX, CY, FX, FY, H, PLANES, W, _make_sequence
from test_torch_lc import one_torch_thread  # noqa: F401 (a fixture)

USER_CONFIG = "--n_poses_to_sample 2048 --depth_rand_samples 6"
# fields of the port's vo_window events that its tracer writes (utils/profiling.py)
TRACE_FIELDS = ("spans", "host_reads", "reads_by_site", "read_wait_s", "counts", "dispatched_fid")


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
        for k in TRACE_FIELDS:  # the port's tracer: no JAX counterpart
            e.pop(k, None)
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
    # one VO edge per frame transition (the mapping thread adds link edges)
    assert sum(e.edge_type in ("vo", "none") for e in slam.edges) == slam.N_FRAMES - 1
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
    """An engine-side --resize_factor is refused under the SLAM layer, as
    the JAX package refuses it (engine.py:738-742): the layer hands the
    engine per-transition flow lists, and resizing is its own duty."""
    slam = TSLAM(mode="mono", device="cpu")
    slam.set_cam_params(FX, FY, CX, CY)
    slam.voldor_user_config = USER_CONFIG + " --resize_factor 0.5"
    slam.flows = [f for f in sequence[1]]
    slam.N_FRAMES = len(slam.flows) + 1
    slam.flow_loader_pt = len(slam.flows)
    with pytest.raises(ValueError, match="resize_factor"):
        slam.process_vo()


@pytest.mark.parametrize("call", [
    "debug_dir", "kitti_estimate_ground", "resize_factor", "loop_closure_without_cv2",
    "image_loader_without_cv2",
])
def test_unported_entry_points_raise(call, sequence, monkeypatch, tmp_path, one_torch_thread):
    """The entry points that used to raise: debug_dir now writes the
    window's dumps and kitti_estimate_ground leaves a finite ground estimate
    on the window's engine; an engine-side resize_factor raises ValueError
    under the SLAM layer, as in the JAX package; loop closure and the image
    loader raise RuntimeError naming cv2 where it does not import (the JAX
    package runs on without loop closure there)."""
    slam = TSLAM(mode="mono", device="cpu")
    if call.endswith("without_cv2"):
        monkeypatch.setitem(sys.modules, "cv2", None)
        if call == "image_loader_without_cv2":
            slam.h, slam.w = H, W
            fn, args = slam.image_loader, (str(tmp_path),)
        else:
            fn, args = slam.enable_loop_closure, ()
        with pytest.raises(RuntimeError, match="cv2"):
            fn(*args)
        assert not slam._use_loop_closure
        return
    slam.set_cam_params(FX, FY, CX, CY)
    slam.voldor_user_config = USER_CONFIG + {
        "debug_dir": "", "kitti_estimate_ground": " --kitti_estimate_ground 1",
        "resize_factor": " --resize_factor 0.5"}[call]
    if call == "debug_dir":
        slam.debug_dir = str(tmp_path)
    slam.flows = [f for f in sequence[1]]
    slam.N_FRAMES = len(slam.flows) + 1
    slam.h, slam.w = H, W
    slam.flow_loader_pt = len(slam.flows)
    if call == "resize_factor":
        with pytest.raises(ValueError, match="resize_factor"):
            slam.process_vo()
        return
    slam.vo_pipeline = False  # one window is enough
    handles = []
    dispatch = slam._vo_dispatch
    slam._vo_dispatch = lambda inputs: handles.append(dispatch(inputs)) or handles[-1]
    assert slam.process_vo()
    if call == "debug_dir":
        for part in ("depth.npy", "depth_conf.npy", "rigidness.npy"):
            assert (tmp_path / f"window_000000_{part}").exists()
    else:
        g = handles[0].engine.ground
        assert np.isfinite(g.height) and np.isfinite(g.normal).all()


# --------------------------------------------------------------------------
# (h) the mapping half: links, PGO, the mapping thread
# --------------------------------------------------------------------------



def _texture(K, T, depth):
    """A world-anchored intensity (bench.py:276-297's idea, smooth here)."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K.astype(np.float64)).T
    Xw = (rays * depth[..., None] - T[:3, 3]) @ T[:3, :3]
    return (0.5 + 0.2 * np.sin(2.1 * Xw[..., 0]) * np.cos(1.7 * Xw[..., 1])
            + 0.2 * np.sin(0.9 * Xw[..., 0] + 1.3 * Xw[..., 1])).astype(np.float32)


@pytest.fixture(scope="module")
def keyframe_map():
    """Eight frames of the gentle test_slam sequence with their true depths
    (1% noise, so the robustifier does not zero every Jacobian), confidences
    and textured images; frames 0, 2, 4, 6 are keyframes; a slight drift on
    the map poses."""
    _, _, _, Ts = _make_sequence(7, tx=0.3)
    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(41)
    frames = []
    for k, T in enumerate(Ts):
        d = plane_depth(K, T[:3, :3], T[:3, 3], PLANES, H, W).astype(np.float32)
        Tcw = np.linalg.inv(T).astype(np.float32)
        Tcw[:3, 3] *= 1.0 + 0.01 * k
        frames.append(dict(
            Tcw=Tcw, depth=(d * (1 + 0.01 * rng.standard_normal(d.shape))).astype(np.float32),
            conf=rng.uniform(0.5, 1.0, d.shape).astype(np.float32),
            image=_texture(K, T, d), scale=1.0 + 0.02 * k))
    return frames


def _mapped_slam(cls, frame_cls, edge_cls, fmap, **kw):
    slam = cls(mode="mono", **kw)
    slam.set_cam_params(FX, FY, CX, CY)
    slam.h, slam.w = H, W
    slam.N_FRAMES = len(fmap) + 1
    for k, f in enumerate(fmap):
        fr = frame_cls(f["Tcw"], f["depth"].copy(), f["conf"].copy(), scale=f["scale"],
                       is_keyframe=k % 2 == 0)
        slam.frames.append(fr)
        if k % 2 == 0:
            slam.kf_ids.append(k)
        if k:
            rel = np.linalg.inv(fmap[k]["Tcw"]) @ fmap[k - 1]["Tcw"]
            slam.edges.append(edge_cls(k - 1, k, T44_to_T6(rel),
                                       np.diag([1e-4] * 3 + [1e-3] * 3).astype(np.float32),
                                       edge_type="vo"))
    slam.Twc_cur = np.linalg.inv(fmap[-1]["Tcw"]).astype(np.float32)
    slam.images_grayf = [f["image"] for f in fmap]
    slam.image_loader_pt = len(fmap)
    # the far pair (0, 6) sees ~0.73 of its partner, the others >= 0.87
    slam.mp_link_visibility_thresh = slam.lc_link_visibility_thresh = 0.8
    events = []
    slam.metrics.log = lambda event, **k: events.append(dict(event=event, **k))
    return slam, events



@pytest.mark.parametrize("kind", ["local", "lc"])
def test_links_batch_matches_jax(keyframe_map, kind, monkeypatch):
    """establish_links_batch on identical injected keyframes in both
    VOLDOR_SLAMs: the same gate decisions and metrics; consistency within
    1e-3 and visibility within 1e-2,
    edge poses within 6e-3 and covariance diagonals within 10% (7-dof mono
    links: the JAX package itself moves these local-link poses by up to
    5.4e-3, and the covariance diagonals by 3%, when the map poses move by
    1e-6; tests/test_torch_falign.py says why;
    test_link_edges_match_jax_at_equal_alignments holds the edges to JAX's
    without that noise). cv2 is hidden from the JAX
    side, so both blur with the same separable Gaussian (at the
    loop-closure image width, 9, cv2's own taps differ)."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    pairs = [(0, 2), (2, 4), (0, 6), (4, 6)]
    j, jev = _mapped_slam(JSLAM, JFrame, JEdge, keyframe_map)
    t, tev = _mapped_slam(TSLAM, TFrame, TEdge, keyframe_map, device="cpu")
    n0 = len(j.edges)
    j.establish_links_batch(pairs, kind=kind)
    t.establish_links_batch(pairs, kind=kind)
    assert [e["accepted"] for e in tev] == [e["accepted"] for e in jev]
    assert any(e["accepted"] for e in tev) and not all(e["accepted"] for e in tev)
    for a, b in zip(tev, jev):
        assert (a["event"], a["kf_ids"], a["rejected_by"]) == (b["event"], b["kf_ids"], b["rejected_by"])
        assert abs(a["consistency"] - b["consistency"]) <= 1e-3
        # the share of pixels landing inside the partner frame: a few
        # border pixels (of ~700) move with the pose
        assert abs(a["visibility"] - b["visibility"]) <= 1e-2
    assert len(t.edges) == len(j.edges) > n0
    for a, b in zip(t.edges[n0:], j.edges[n0:]):
        assert (a.fid1, a.fid2, a.edge_type) == (b.fid1, b.fid2, b.edge_type)
        np.testing.assert_allclose(a.pose, b.pose, rtol=0, atol=6e-3)
        assert np.linalg.matrix_rank(a.pose_covar) == np.linalg.matrix_rank(b.pose_covar) == 7
        np.testing.assert_allclose(np.diag(a.pose_covar), np.diag(b.pose_covar), rtol=0.1)


@pytest.mark.parametrize("kind", ["local", "lc"])
def test_link_edges_match_jax_at_equal_alignments(keyframe_map, kind, monkeypatch):
    """establish_links_batch with the port's falign_pairs replaying the JAX
    package's answers, which takes the LM's float noise out: each side hands
    falign_pairs the same inputs (blurred depths and images within 1e-5,
    confidences, inits and settings equal), and from the same answers both
    take the same gate decisions and append the same edges (poses within
    1e-6, the scale entry included; covariances equal)."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    pairs = [(0, 2), (2, 4), (0, 6), (4, 6)]
    j, jev = _mapped_slam(JSLAM, JFrame, JEdge, keyframe_map)
    t, tev = _mapped_slam(TSLAM, TFrame, TEdge, keyframe_map, device="cpu")
    j_calls, answers, t_calls = [], [], []
    real = jfalign_api.falign_pairs

    def record(**kw):
        j_calls.append(kw)
        answers.append(real(**kw))
        return answers[-1]

    def replay(**kw):
        t_calls.append(kw)
        return answers[len(t_calls) - 1]

    monkeypatch.setattr(jfalign_api, "falign_pairs", record)
    monkeypatch.setattr(tfalign_api, "falign_pairs", replay)
    n0 = len(j.edges)
    j.establish_links_batch(pairs, kind=kind)
    t.establish_links_batch(pairs, kind=kind)
    assert len(t_calls) == len(j_calls) == (2 if kind == "lc" else 1)
    for tk, jk in zip(t_calls, j_calls):
        assert tk.pop("device") == t.device
        assert sorted(tk) == sorted(jk)
        for key, jv in jk.items():
            np.testing.assert_allclose(np.asarray(tk[key], np.float64),
                                       np.asarray(jv, np.float64), rtol=0, atol=1e-5, err_msg=key)
    assert tev == jev
    assert any(e["accepted"] for e in tev) and not all(e["accepted"] for e in tev)
    assert len(t.edges) == len(j.edges) > n0
    for a, b in zip(t.edges[n0:], j.edges[n0:]):
        assert (a.fid1, a.fid2, a.edge_type) == (b.fid1, b.fid2, b.edge_type)
        np.testing.assert_allclose(a.pose, b.pose, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(a.pose_covar, b.pose_covar)


@pytest.mark.parametrize("fid_start", [0, 2])
def test_solve_pgo_matches_jax(keyframe_map, fid_start):
    """solve_pgo on the same graph (VO edges plus two link edges): the
    rebased poses, scales and live camera within tolerance, one map
    version bump and the pgo metrics event on both sides."""
    j, jev = _mapped_slam(JSLAM, JFrame, JEdge, keyframe_map)
    t, tev = _mapped_slam(TSLAM, TFrame, TEdge, keyframe_map, device="cpu")
    for a, b, cov in ((0, 4, 2e-3), (2, 6, 1e-3)):
        rel = np.linalg.inv(keyframe_map[b]["Tcw"]) @ keyframe_map[a]["Tcw"]
        pose7 = np.zeros(7, np.float32)
        pose7[:6] = T44_to_T6(rel)
        pose7[6] = np.log(keyframe_map[b]["scale"] / keyframe_map[a]["scale"]) * 0.5
        for slam, cls in ((j, JEdge), (t, TEdge)):
            slam.edges.append(cls(a, b, pose7, np.eye(7, dtype=np.float32) * cov,
                                  edge_type="falign-local"))
    j.solve_pgo(fid_start)
    t.solve_pgo(fid_start)
    assert j._map_version == t._map_version == 1
    assert [(e["fid_start"], e["n_frames"], e["n_edges"]) for e in tev] == \
        [(e["fid_start"], e["n_frames"], e["n_edges"]) for e in jev]
    for fa, fb in zip(t.frames, j.frames):
        np.testing.assert_allclose(fa.Tcw, fb.Tcw, rtol=0, atol=2e-4)
        np.testing.assert_allclose(fa.scale, fb.scale, rtol=2e-4)
    np.testing.assert_allclose(t.Twc_cur, j.Twc_cur, rtol=0, atol=2e-4)
    moved = max(np.abs(f.Tcw - keyframe_map[k]["Tcw"]).max() for k, f in enumerate(t.frames))
    assert moved > 1e-3  # the link edges pulled the map


class _KeyframeFeed:
    """end_of_vo as a property that delivers one keyframe every third read
    of it: the mapping loop reads it once per pass (and once more in its
    idle branch), so keyframe arrival is a function of the loop's own
    progress, with no clock or thread involved. lc: {n_keyframes: (rid,
    qid)}, a loop-closure candidate appended two reads after that many
    keyframes were delivered, as append_kf appends one after its
    keyframe."""

    def __init__(self, order, lc=None):
        self.order = list(order)
        self.reads = 0
        self.lc = dict(lc or {})
        self.lc_at = None

    def read(self, slam):
        self.reads += 1
        if self.order and self.reads % 3 == 0:
            slam.kf_ids.append(self.order.pop(0))
            if len(slam.kf_ids) in self.lc:
                self.lc_at = (self.reads + 2, self.lc.pop(len(slam.kf_ids)))
        if self.lc_at is not None and self.reads == self.lc_at[0]:
            slam.lc_candidates.append(self.lc_at[1])
            self.lc_at = None
        return not self.order


def _feeding(cls):
    class Fed(cls):
        feed = None

        @property
        def end_of_vo(self):
            return self.feed.read(self) if self.feed is not None else False

        @end_of_vo.setter
        def end_of_vo(self, v):
            pass

    return Fed


def _stub_falign_pairs(depths, fx, fy, cx, cy, weights=None, images=None, poses_init=None,
                       optimize_7dof=False, **kw):
    """One answer per lane from its inputs alone: the init pose back, a unit
    covariance, and scores that pass the gates only while the two depth
    maps' means are close (near keyframes)."""
    out = []
    for i in range(depths.shape[0]):
        close = abs(float(depths[i, 0].mean()) - float(depths[i, 1].mean())) < 0.08
        d = 7 if optimize_7dof else 6
        vm = np.full((2, 2), np.nan, np.float32)
        cm = np.full((2, 2), np.nan, np.float32)
        vm[0, 1] = vm[1, 0] = 0.9 if close else 0.5
        cm[0, 1] = cm[1, 0] = 0.95
        out.append(dict(poses_ret=(poses_init[i] if poses_init is not None
                                   else np.zeros((2, 6), np.float32)),
                        poses_covar=np.tile(np.eye(d, dtype=np.float32) * 1e-4, (2, 1, 1)),
                        scaling_factor=np.ones(2, np.float32), visibility_mat=vm,
                        consistency_mat=cm, iters=1, iters_coarse=0))
    return out


def _stub_pgo(poses, edges_idx, edges_pose, edges_covar=None, poses_idx=None,
              optimize_7dof=False, **kw):
    return np.asarray(poses, np.float32).copy()


# wall-clock fields of the metrics events: not parity properties
WALL_CLOCK = ("t", "solve_s", "window_s")


@pytest.mark.parametrize("lc", [False, True])
def test_mapping_thread_schedules_as_jax(monkeypatch, lc):
    """The mapping thread's scheduler in both packages, with falign_pairs and
    pgo stubbed (module attributes; nothing in voldor_tpu is edited) and a
    deterministic keyframe arrival (_KeyframeFeed), the link age limit set
    high: the same sequence of (pair_list, kind) dispatches and of
    solve_pgo(fid_start) calls, the same edges and the same metrics events
    but for their wall-clock fields. With lc, loop-closure candidates land
    mid-run on both sides: the same ("links", "lc", ...) dispatches, each
    followed by a global solve_pgo(0), and falign-lc edges (the stub passes
    them: mono LC links normalise both depth medians to 10)."""
    monkeypatch.setattr(jfalign_api, "falign_pairs", _stub_falign_pairs)
    monkeypatch.setattr(tfalign_api, "falign_pairs", _stub_falign_pairs)
    monkeypatch.setattr(jpgo_api, "pgo", _stub_pgo)
    monkeypatch.setattr(tpgo_api, "pgo", _stub_pgo)
    n_frames, kf_every = 97, 3
    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
    runs = {}
    for name, cls, fcls, ecls, kw in (("jax", JSLAM, JFrame, JEdge, {}),
                                      ("port", TSLAM, TFrame, TEdge, {"device": "cpu"})):
        slam = _feeding(cls)(mode="mono", **kw)
        slam.aot_warmup = False  # the JAX package's compile warm-up thread
        slam.set_cam_params(FX, FY, CX, CY)
        slam.mp_link_max_delay_s = 1e9
        slam.pgo_local_kf_winsize = 8
        slam.N_FRAMES = n_frames
        Ts = []
        for k in range(n_frames - 1):
            T = np.eye(4, dtype=np.float32)
            T[:3, 3] = [0.1 * k, 0.0, 0.0]
            Ts.append(T)
            depth = np.full((H, W), 5.0 + 0.01 * k, np.float32)
            slam.frames.append(fcls(T, depth, np.ones((H, W), np.float32)))
            if k:
                slam.edges.append(ecls(k - 1, k, np.asarray([0, 0, 0, -0.1, 0, 0], np.float32),
                                       np.eye(6, dtype=np.float32) * 1e-4, edge_type="vo"))
        slam.Twc_cur = np.linalg.inv(Ts[-1])
        slam.images_grayf = [np.zeros((H, W), np.float32)] * n_frames
        slam.image_loader_pt = n_frames
        calls = []
        real_links, real_pgo = slam.establish_links_batch, slam.solve_pgo

        def links(pair_list, kind="local", real=real_links, calls=calls, depth=[0]):
            if depth[0] == 0:  # the JAX package splits big batches itself
                calls.append(("links", kind, [tuple(int(x) for x in p) for p in pair_list]))
            depth[0] += 1
            try:
                real(pair_list, kind=kind)
            finally:
                depth[0] -= 1

        def pgo(fid_start=0, real=real_pgo, calls=calls):
            calls.append(("pgo", int(fid_start)))
            real(fid_start)

        slam.establish_links_batch, slam.solve_pgo = links, pgo
        events = []
        slam.metrics.log = lambda event, events=events, **k: events.append(dict(event=event, **k))
        slam.feed = _KeyframeFeed(range(0, n_frames - 1, kf_every),
                                  lc={20: (2, 19), 27: (6, 26)} if lc else None)
        slam.mapping_thread()
        for e in events:
            for k in WALL_CLOCK:
                e.pop(k, None)
        runs[name] = (slam, calls, events)
    (j, jc, je), (t, tc, te) = runs["jax"], runs["port"]
    assert jc == tc
    kinds = [c[0] for c in tc]
    assert kinds.count("pgo") >= 3 and tc[-1] == ("pgo", 0)
    assert any(c[0] == "pgo" and c[1] > 0 for c in tc)  # a windowed PGO
    assert any(c[0] == "links" and len(c[2]) >= 12 for c in tc)  # a filled batch
    assert je == te
    lc_calls = [i for i, c in enumerate(tc) if c[:2] == ("links", "lc")]
    if lc:
        assert j.lc_candidates == t.lc_candidates == [(2, 19), (6, 26)]
        assert len(lc_calls) >= 2 and (6, 57) in tc[lc_calls[0]][2]  # kf ordinals 2, 19
        for i in lc_calls:  # a global PGO follows each LC dispatch before the end
            assert ("pgo", 0) in tc[i + 1:-1]
        assert any(e.edge_type == "falign-lc" for e in t.edges)
        assert any(e["event"] == "lc_link" and e["accepted"] for e in te)
    else:
        assert not lc_calls
    assert [(e.fid1, e.fid2, e.edge_type) for e in j.edges] == \
        [(e.fid1, e.fid2, e.edge_type) for e in t.edges]
    assert any(e.edge_type == "falign-local" for e in t.edges)
    assert any(not e["accepted"] for e in te)


def test_vo_and_mapping_threads_end_to_end():
    """vo_thread + mapping_thread on the CPU at 72x96: both threads end, every
    pose is finite, local links are accepted, the final global PGO ran, and
    the trajectory keeps its shape (test_slam_mono_vo_trajectory's gates)."""
    poses, flows, depth0, Ts = _make_sequence(10, tx=0.3, flow_noise=0.05)
    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
    slam = TSLAM(mode="mono", device="cpu")
    slam.voldor_user_config = USER_CONFIG
    slam.set_cam_params(FX, FY, CX, CY)
    slam.flows = [flows[i] for i in range(flows.shape[0])]
    slam.N_FRAMES = flows.shape[0] + 1
    slam.h, slam.w = H, W
    slam.flow_loader_pt = flows.shape[0]
    slam.images_grayf = [_texture(K, T, plane_depth(K, T[:3, :3], T[:3, 3], PLANES, H, W))
                         for T in Ts]
    slam.image_loader_pt = len(slam.images_grayf)
    slam.mp_link_visibility_thresh = 0.6
    events = []
    slam.metrics.log = lambda event, **k: events.append(dict(event=event, **k))
    vo = threading.Thread(target=slam.vo_thread, daemon=True)
    mp = threading.Thread(target=slam.mapping_thread, daemon=True)
    vo.start()
    mp.start()
    vo.join(timeout=300)
    mp.join(timeout=300)
    assert not vo.is_alive() and not mp.is_alive()
    assert all(np.isfinite(f.Tcw).all() for f in slam.frames)
    assert any(e.edge_type == "falign-local" for e in slam.edges)
    pgo = [e for e in events if e["event"] == "pgo"]
    assert pgo and pgo[-1]["fid_start"] == 0
    _check_trajectory(slam, Ts)
