"""The pose sweep's collect (voldor_tpu_torch/ops/pose_collect.py): the
wrapper the sweeps call, its kernel's argument checks, the sweeps and a
traced stream through its kernel route, and the benchmark's reader of its
launch count.

* On CPU tensors the wrapper is the plain collect, bitwise:
  ``collect_p3p_instances`` (traced, every target) and
  ``collect_p3p_instances_obs`` (obs, every active_n) at 64x96, N = 5 and
  8, strides 1 and 2, ``max_trace_on_flow`` 0, 1 and 3, with NaN, +inf,
  negative and out-of-range depths, rigidness NaN in places, poses that
  carry the traces out of the image, in-bounds flags false mid-window, the
  rigidness-sum test on and the far-depth test off.
* The obs kernel's walk, written here in torch ops (``_obs_walk``: no
  rolling products, the running AND of the rigidness tests), is the plain
  obs collect bitwise on the same cases: the kernel's premise.
* The kernel's checks run on ``meta`` tensors, which take the kernel's
  route but never reach a launch.
* With the launch stubbed on the CPU (the plain traced collect and
  ``_obs_walk``), both sweep cores give bitwise the outputs of the plain
  route on a small stereo stream, and each traced ``process_vo`` call's
  ``vo_window`` counts carry one ``pose.collect`` per attempted target of
  the sequential sweep and per Jacobi sweep.
* The kernel itself runs only on a CUDA device (tests marked ``gpu``):
  there both modes are bitwise the plain version run on the same card.
  This file imports no JAX: ``pytest --noconftest -m gpu`` runs it on a
  card.
"""

import collections
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from voldor_tpu_torch.config import VoldorConfig
from voldor_tpu_torch.ops import lie
from voldor_tpu_torch.ops import pose_collect as pc
from voldor_tpu_torch.ops.chain_trace import _backproject, _pixel_grid, _transform
from voldor_tpu_torch.slam.system import VOLDOR_SLAM
from voldor_tpu_torch.utils import profiling
from voldor_tpu_torch.vo import em, engine, pose_step

from synthetic import plane_depth, render_window

ROOT = Path(__file__).resolve().parent.parent
H, W = 64, 96
PLANES = [
    (np.array([0.1, 0.15, 1.0]) / np.linalg.norm([0.1, 0.15, 1.0]), 8.0),
    (np.array([-0.35, 0.1, 1.0]) / np.linalg.norm([-0.35, 0.1, 1.0]), 6.5),
    (np.array([0.3, -0.25, 1.0]) / np.linalg.norm([0.3, -0.25, 1.0]), 7.0),
]
CKW = dict(rigidness_threshold=0.5, rigidness_sum_threshold=1.0, sample_min_depth=0.1,
           sample_max_depth=1000.0, max_trace_on_flow=3, sample_stride=1)


def _r2R(rv):
    return lie.so3_exp(torch.as_tensor(np.asarray(rv, np.float32))).numpy()


def _window(n):
    """(depth, flows, rigidness, Rs, ts, p) of an n-frame window at H x W:
    rendered flows with noise, rigidness uniform in [0.3, 1] with NaN
    patches, and the depths the collect must refuse: NaN, +inf, negative,
    below the least and beyond the greatest sample depth."""
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(20 + n)
    poses = np.zeros((n, 6), np.float32)
    for f in range(n):
        poses[f, :3] = rng.normal(0, 0.01, 3)
        poses[f, 3:6] = [0.35 + 0.05 * rng.normal(), 0.05 * rng.normal(), 0.2]
    flows, depth0, _ = render_window(K, poses, PLANES, H, W, _r2R)
    flows = torch.as_tensor(flows + rng.normal(0, 0.5, flows.shape).astype(np.float32))
    depth = torch.as_tensor(depth0 * 1.02)
    depth[3:6, 10:40] = torch.nan
    depth[8, 5:60] = torch.inf
    depth[12:15, 30:50] = -2.0
    depth[20:22, :] = 0.05
    depth[40:43, 60:90] = 2000.0
    rig = torch.as_tensor(rng.uniform(0.3, 1.0, (n, H, W)).astype(np.float32))
    rig[1, 30:34, 20:70] = torch.nan
    cfg = VoldorConfig(fx=60.0, fy=60.0, cx=W / 2, cy=H / 2, basefocal=20.0)
    p = em.EmParams.from_config(cfg, has_disparity=False)
    return dict(depth=depth, flows=flows.contiguous(), rig=rig,
                Rs=lie.so3_exp(torch.as_tensor(poses[:, :3])),
                ts=torch.as_tensor(poses[:, 3:6]), p=p)


@pytest.fixture(scope="module")
def windows():
    return {n: _window(n) for n in (5, 8)}


VARIANTS = ("shipped", "edges", "rig_sum", "no_far")


def _variant(win, name, M, stride):
    """(ts, ckw) of one variant: the shipped thresholds; poses towards the
    scene (chain points behind the camera, traces started off the map);
    the rigidness-sum test on; the far-depth test off."""
    ts, ckw = win["ts"].clone(), dict(CKW, max_trace_on_flow=M, sample_stride=stride)
    N = win["rig"].shape[0]
    if name == "edges":
        ts[:, 2] = -3.0
        ts[:, 0] = 2.5
    elif name == "rig_sum":
        ckw["rigidness_sum_threshold"] = N + 1.5
    elif name == "no_far":
        ckw["sample_max_depth"] = 0.0
    return ts, ckw


def _obs_inputs(win, active_n):
    """The observed tracks of the window's flows, their in-bounds flags
    false over a patch from frame 2 on (a track lost mid-window)."""
    track, tinb = em.precompute_obs_tracks(win["flows"], active_n, win["p"])
    tinb = tinb.clone()
    tinb[2, 44:52, 8:40] = False
    return track, tinb


def _same(a, b):
    """Bitwise equal as floats, NaN where NaN."""
    return bool(a.shape == b.shape and torch.equal(a.isnan(), b.isnan())
                and torch.equal(torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0)))


def _assert_same(out, ref):
    (p2, p3, v), (rp2, rp3, rv) = out, ref
    assert v.dtype == torch.bool and torch.equal(v, rv)
    assert _same(p2, rp2) and _same(p3, rp3)


def _cases(win, mode):
    """(active, extra inputs) of every target (traced) or active_n (obs)."""
    N = win["rig"].shape[0]
    if mode == "traced":
        return [(a, dict(flows=win["flows"])) for a in range(N)]
    out = []
    for n in range(0, N + 1):
        track, tinb = _obs_inputs(win, n)
        out.append((n, dict(obs_track=track, obs_tinb=tinb)))
    return out


def _plain(win, ts, active, ckw, flows=None, obs_track=None, obs_tinb=None):
    args = (win["rig"], win["Rs"], ts, active, win["p"])
    if obs_track is None:
        return pose_step.collect_p3p_instances(win["depth"], flows, *args, **ckw)
    return pose_step.collect_p3p_instances_obs(win["depth"], obs_track, obs_tinb, *args, **ckw)


@pytest.mark.parametrize("M", [0, 1, 3])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("N", [5, 8])
@pytest.mark.parametrize("mode", ["traced", "obs"])
def test_cpu_wrapper_is_the_plain_collect_bitwise(windows, mode, N, stride, M):
    win = windows[N]
    before = pc.pose_collect_launches
    n_valid = 0
    for name in VARIANTS:
        ts, ckw = _variant(win, name, M, stride)
        for active, extra in _cases(win, mode):
            out = pc.pose_collect(win["depth"], win["rig"], win["Rs"], ts, active, win["p"],
                                  **extra, **ckw)
            _assert_same(out, _plain(win, ts, active, ckw, **extra))
            n_valid += int(out[2].sum())
            hs, ws = -(-H // stride), -(-W // stride)
            lead = (hs, ws) if mode == "traced" else (N, hs, ws)
            assert out[0].shape == lead + (2,) and out[1].shape == lead + (3,)
    assert n_valid > 0
    assert pc.pose_collect_launches == before


def _obs_walk(depth, obs_track, obs_tinb, rigidness, Rs, ts, active_n, p, *,
              rigidness_threshold, rigidness_sum_threshold, sample_min_depth,
              sample_max_depth, max_trace_on_flow, sample_stride=1):
    """The obs kernel's walk (csrc/pose_collect.cu) in torch ops, a pixel
    an element: frame by frame the running AND of the rigidness tests of
    the frames below active_n and of the in-bounds flags; no rolling
    products, so ``max_trace_on_flow`` takes no part."""
    N, h, w = rigidness.shape
    s = sample_stride
    tx, ty, obx, oby = (t[:, ::s, ::s] for t in obs_track)
    xs, ys = (g[::s, ::s] for g in _pixel_grid(h, w, depth.device))
    depth, rig, tinb = depth[::s, ::s], rigidness[:, ::s, ::s], obs_tinb[:, ::s, ::s]
    far_on = not sample_max_depth <= 0
    ok0 = (depth >= sample_min_depth) & (~torch.tensor(far_on) | (depth <= sample_max_depth))
    if rigidness_sum_threshold > N + 1:
        ok0 = ok0 & ~(rig.sum(dim=0) < rigidness_sum_threshold)
    ox, oy, oz = _backproject(xs, ys, depth, p)
    cum_rig = torch.ones_like(ok0)
    cum_inb = torch.ones_like(ok0)
    outs = []
    for f in range(N):
        active = f < active_n
        if active:
            cum_rig = cum_rig & (rig[f] > rigidness_threshold)
        cum_inb = cum_inb & tinb[f]
        p2x, p2y = tx[f] + obx[f], ty[f] + oby[f]
        in_range = (oz > sample_min_depth) & (~torch.tensor(far_on) | (oz < sample_max_depth))
        finite = (torch.isfinite(ox) & torch.isfinite(oy) & torch.isfinite(oz)
                  & torch.isfinite(p2x) & torch.isfinite(p2y))
        valid = ok0 & active & cum_rig & in_range & cum_inb & finite
        outs.append((p2x, p2y, ox, oy, oz, valid))
        ox, oy, oz = _transform(Rs[f], ts[f], ox, oy, oz)
    p2x, p2y, p3x, p3y, p3z, valid = (torch.stack(c) for c in zip(*outs))
    return torch.stack([p2x, p2y], dim=-1), torch.stack([p3x, p3y, p3z], dim=-1), valid


@pytest.mark.parametrize("M", [0, 1, 3])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("N", [5, 8])
def test_obs_walk_without_products_is_the_plain_collect(windows, N, stride, M):
    win = windows[N]
    for name in VARIANTS:
        ts, ckw = _variant(win, name, M, stride)
        for n, extra in _cases(win, "obs"):
            walk = _obs_walk(win["depth"], extra["obs_track"], extra["obs_tinb"], win["rig"],
                             win["Rs"], ts, n, win["p"], **ckw)
            _assert_same(walk, _plain(win, ts, n, ckw, **extra))


# the kernel's checks, on meta tensors


def _meta(n=5, dtype=torch.float32, contiguous=True, obs=False):
    def t(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    rig = t(n, H, W) if contiguous else t(n, H, W + 3)[:, :, :W]
    kw = dict(flows=t(n, H, W, 2))
    if obs:
        kw = dict(obs_track=tuple(t(n, H, W) for _ in range(4)),
                  obs_tinb=t(n, H, W, dt=torch.bool))
    return (t(H, W), rig, t(n, 3, 3), t(n, 3)), kw


@pytest.mark.parametrize("args, active, exc, match", [
    (dict(n=pc.MAX_N + 1), 0, ValueError, "window frames"),
    (dict(n=0), 0, ValueError, "window frames"),
    (dict(), 5, ValueError, "outside the window"),
    (dict(dtype=torch.float64), 0, TypeError, "dtype"),
    (dict(contiguous=False), 0, ValueError, "contiguous"),
    (dict(), 2, ValueError, "unsupported device"),
    (dict(obs=True), 3, ValueError, "unsupported device"),
])
def test_kernel_route_refuses_what_it_cannot_take(windows, args, active, exc, match):
    (depth, rig, Rs, ts), kw = _meta(**args)
    before = pc.pose_collect_launches
    with pytest.raises(exc, match=match):
        pc.pose_collect(depth, rig, Rs, ts, active, windows[5]["p"], **kw, **CKW)
    assert pc.pose_collect_launches == before


def test_kernel_route_refuses_mismatched_inputs(windows):
    (depth, rig, Rs, ts), kw = _meta()
    p = windows[5]["p"]
    with pytest.raises(ValueError, match="shape"):
        pc.pose_collect(torch.empty((H, W - 1), device="meta"), rig, Rs, ts, 1, p, **kw, **CKW)
    with pytest.raises(ValueError, match="shape"):
        pc.pose_collect(depth, rig, Rs[:-1], ts, 1, p, **kw, **CKW)
    (_, _, _, _), okw = _meta(obs=True)
    okw["obs_tinb"] = okw["obs_tinb"].float()
    with pytest.raises(TypeError, match="obs_tinb"):
        pc.pose_collect(depth, rig, Rs, ts, 1, p, **okw, **CKW)
    with pytest.raises(ValueError, match="stride"):
        pc.pose_collect(depth, rig, Rs, ts, 1, p, **kw, **dict(CKW, sample_stride=0))


# the sweeps and a traced stream through the kernel route, the launch
# stubbed on the CPU

S_H, S_W, S_F = 40, 56, 48.0
N_FLOWS = 16
USER_CONFIG = "--n_poses_to_sample 512 --depth_rand_samples 4"


def _stub_launch(depth, rigidness, Rs, ts, active, p, flows, obs_track, obs_tinb, ckw):
    """The kernel's outputs on the CPU: the plain traced collect, the obs
    kernel's walk."""
    if obs_track is None:
        return pose_step.collect_p3p_instances(depth, flows, rigidness, Rs, ts, active, p, **ckw)
    return _obs_walk(depth, obs_track, obs_tinb, rigidness, Rs, ts, active, p, **ckw)


def _stream_slam():
    rng = np.random.default_rng(5)
    poses = np.zeros((N_FLOWS, 6), np.float32)
    for f in range(N_FLOWS):
        poses[f, :3] = rng.normal(0, 0.008, 3)
        poses[f, 3:6] = [0.45 + 0.03 * rng.normal(), 0.03 * rng.normal(), 0.18]
    K = np.array([[S_F, 0, S_W / 2], [0, S_F, S_H / 2], [0, 0, 1]], np.float32)
    flows, _, Ts = render_window(K, poses, PLANES, S_H, S_W, _r2R)
    bf = 0.5 * S_F
    slam = VOLDOR_SLAM(mode="stereo", device="cpu")
    slam.use_image_info = False
    slam.voldor_user_config = USER_CONFIG
    slam.set_cam_params(S_F, S_F, S_W / 2, S_H / 2, basefocal=bf)
    slam.disps = [(bf / plane_depth(K, Ts[k][:3, :3], Ts[k][:3, 3], PLANES, S_H, S_W))
                  .astype(np.float32) for k in range(N_FLOWS)]
    slam.disp_loader_pt = N_FLOWS
    slam.flows = [flows[i] for i in range(N_FLOWS)]
    slam.N_FRAMES = N_FLOWS + 1
    slam.h, slam.w = S_H, S_W
    slam.flow_loader_pt = N_FLOWS
    return slam


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """The stream twice: on the plain route, and on the kernel route with
    the launch stubbed and the metrics logger open, each sweep core's
    results recorded, and each attempted target of the sequential sweep
    counted in the call's record (``test.target``)."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    runs = {}
    try:
        for route in ("plain", "kernel"):
            seen = collections.defaultdict(list)
            with pytest.MonkeyPatch.context() as mp:
                for name in ("_cameras_window_core", "_cameras_window_jacobi_core"):
                    real = getattr(engine, name)

                    def recorder(*a, _real=real, _name=name, **k):
                        out = _real(*a, **k)
                        seen[_name].append(out)
                        return out
                    mp.setattr(engine, name, recorder)
                real_step = pose_step._pose_step_core

                def step(*a, **k):
                    profiling.count("test.target")
                    return real_step(*a, **k)
                mp.setattr(pose_step, "_pose_step_core", step)
                if route == "kernel":
                    mp.setattr(pc, "_plain_route", lambda depth: False)
                    mp.setattr(pc, "_launch", _stub_launch)
                slam = _stream_slam()
                path = tmp_path_factory.mktemp("collect") / f"{route}.jsonl"
                slam.metrics.open(str(path))
                before = pc.pose_collect_launches
                while slam.process_vo():
                    pass
                slam.metrics.close()
                launches = pc.pose_collect_launches - before
            events = [json.loads(line) for line in path.read_text().splitlines()]
            runs[route] = dict(slam=slam, seen=seen, launches=launches,
                               windows=[e for e in events if e["event"] == "vo_window"])
    finally:
        torch.set_num_threads(n_threads)
    return runs


@pytest.mark.parametrize("core", ["_cameras_window_core", "_cameras_window_jacobi_core"])
def test_sweep_cores_unchanged_through_the_kernel_route(streams, core):
    plain, kern = streams["plain"]["seen"][core], streams["kernel"]["seen"][core]
    assert plain and len(plain) == len(kern)
    for a, b in zip(plain, kern):
        for x, y in zip(a, b):
            if isinstance(x, torch.Tensor):
                assert _same(x, y)
            else:
                assert x == y
    pa, pb = streams["plain"]["slam"], streams["kernel"]["slam"]
    for fa, fb in zip(pa.frames, pb.frames):
        assert np.array_equal(fa.Tcw, fb.Tcw)


def test_vo_window_counts_one_collect_per_target_and_sweep(streams):
    kern, plain = streams["kernel"], streams["plain"]
    assert plain["launches"] == 0
    assert all("pose.collect" not in e["counts"] for e in plain["windows"])
    solved = [e for e in kern["windows"] if e["dispatched_fid"] is not None]
    assert len(solved) >= 3
    total = 0
    for e in kern["windows"]:
        c = e["counts"]
        expect = c.get("test.target", 0) + c.get("pose.sweep.jacobi", 0)
        assert c.get("pose.collect", 0) == expect
        total += expect
    for e in solved:
        assert e["counts"]["test.target"] >= 1 and e["counts"]["pose.sweep.jacobi"] >= 1
    assert kern["launches"] == total > 0


# the benchmark's reader of the count in each call's record


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"reader_{name}", ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_benchmark_reader_of_the_collect_count():
    mod = _reader("pose_collect_per_call")
    ev = [{"event": "keyframe"},
          {"event": "vo_window", "counts": {"pose.collect": 7, "pose.sweep.seq": 1}},
          {"event": "vo_window", "counts": {"pose.collect": 6}},
          {"event": "vo_window", "counts": {"em.chain_trace": 3}}]  # a call with no sweep
    assert mod.value({"events": ev}) == pytest.approx(13 / 3, rel=1e-12)
    # a program without the kernel (the parent's), or without the record, gives nothing
    parent = {"events": [{"event": "vo_window", "counts": {"pose.sweep.seq": 1}}]}
    assert mod.value(parent) is None
    assert mod.value({"events": [{"event": "vo_window", "window_s": 0.1}]}) is None
    assert mod.value({"window_s": 1.0}) is None


# the kernel on a card


@pytest.mark.gpu
@pytest.mark.parametrize("M", [0, 1, 3])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("N", [5, 8])
@pytest.mark.parametrize("mode", ["traced", "obs"])
def test_kernel_matches_plain_on_gpu(windows, mode, N, stride, M):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pose collect kernel has no CPU mode")
    dev = torch.device("cuda")
    win = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in windows[N].items()}
    for name in VARIANTS:
        ts, ckw = _variant(win, name, M, stride)
        for active, extra in _cases(win, mode):
            before = pc.pose_collect_launches
            out = pc.pose_collect(win["depth"], win["rig"], win["Rs"], ts, active, win["p"],
                                  **extra, **ckw)
            assert pc.pose_collect_launches == before + 1
            ref = _plain(win, ts, active, ckw, **extra)
            _assert_same(out, ref)
            again = pc.pose_collect(win["depth"], win["rig"], win["Rs"], ts, active, win["p"],
                                    **extra, **ckw)
            _assert_same(again, out)
