#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: a CUDA device must be present (never falls back to the CPU);
   prints the card's name and power limit from nvidia-smi;
2. build: compiles the hand-written cost kernel (voldor_tpu_torch/csrc)
   with nvcc into voldor_tpu_torch/_build/;
3. kernel vs plain: the kernel against its plain PyTorch version on the
   card at the main path's shapes (185x613, N=5, K in {1,4,10}, D in
   {0,1,2,3} -- D=3 with the stereo disparity slot --, active_n in {5,3}):
   identical +inf pattern, finite values within rtol = atol = 1e-5;
4. the VO windows: three consecutive 5-flow mono VO windows of the bench
   scene (613x185, seed 7) through voldor_tpu_torch's VO entry point on the
   card, with 0, 1 and 2 depth priors and the SLAM layer's constant-velocity
   warm start; each window must register 5 transitions, every engine
   tensor must lie on the card, the cost kernel must have been launched at
   least 8 times per flow-fed EM iteration, and the 16-frame trajectory
   must pass the bench's gate, Sim3 ATE < 0.02 * scene extent;
5. times: the median warm wall time of each window, the kernel and its
   plain version at K=10, N=5, D=2 (CUDA events), fb_smooth's share of a
   window;
6. slam-mono: VOLDOR_SLAM(mode="mono", device="cuda").process_vo over the
   bench's 24-flow scene (25 frames), configured as the bench configures
   it; one checked pass (every window's device covisibility scores equal
   the host gate slam_utils.eval_covisibility within 1e-5, every engine
   tensor and live frame map on the card, >= 8 kernel launches per EM
   iteration, Sim3 ATE < 0.02 * extent), then 3 timed passes;
7. slam-stereo: the same scene with disparity bf / depth (bf = 175) in
   mode="stereo"; one checked pass under the metric ATE gate (no scale
   alignment, < 0.02 * extent), then 1 timed pass.

The second-to-last line of stdout is a JSON record of the kernels; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H, W = 185, 613
WINDOW = 5
N_WINDOWS = 3
FX = FY = 350.0
BASEFOCAL = (FX + FY) * 0.25  # the SLAM layer's virtual basefocal (mono)
# the mono SLAM layer's VO config (voldor_tpu/slam/system.py:183-186, :230-233)
CONFIG = (
    "--silent --meanshift_kernel_var 0.2 --delta 1.5 --max_iters 5 "
    f"--pose_sample_min_depth {BASEFOCAL / 200.0} --pose_sample_max_depth {BASEFOCAL / 1.0}"
)
RTOL = ATOL = 1e-5
SLAM_FLOWS = 24  # the bench's sequence length (bench.py:435)
BF_STEREO = 0.5 * FX  # bench.py:148
COVIS_TOL = 1e-5


def log(*a):
    print(*a, flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def build_scene(np, torch, n_flows):
    """The bench's sequence scene (bench.py:82-113), rendered with the port's
    so3_exp."""
    from synthetic import render_window

    from voldor_tpu_torch.ops.lie import so3_exp

    K = np.array([[FX, 0, W / 2], [0, FY, H / 2], [0, 0, 1]], np.float32)

    def n_(v):
        v = np.asarray(v, np.float64)
        return v / np.linalg.norm(v)

    planes = [
        (n_([0.1, 0.15, 1.0]), 8.0),
        (n_([-0.35, 0.1, 1.0]), 6.5),
        (n_([0.3, -0.25, 1.0]), 7.0),
        (n_([0.5, 0.35, 1.0]), 7.5),
    ]
    rng = np.random.default_rng(7)
    poses = np.zeros((n_flows, 6), np.float32)
    for f in range(n_flows):
        poses[f, :3] = rng.normal(0, 0.004, 3)
        poses[f, 3:6] = [0.08, 0.01, 0.3]

    def r2R(rv):
        return so3_exp(torch.as_tensor(np.asarray(rv, np.float32))).numpy()

    flows, depth0, Ts = render_window(K, poses, planes, H, W, r2R)
    return K, planes, poses, flows, depth0, Ts, r2R


def phase_kernel(np, torch, scene):
    """Kernel against its plain version at the main path's shapes."""
    from synthetic import plane_depth

    from voldor_tpu_torch.config import VoldorConfig
    from voldor_tpu_torch.ops import cost as cost_mod
    from voldor_tpu_torch.ops.lie import T44_to_pose6, so3_exp
    from voldor_tpu_torch.vo import em

    K, planes, poses, flows, depth0, Ts, _ = scene
    dev = torch.device("cuda")
    cfg = VoldorConfig(fx=FX, fy=FY, cx=W / 2, cy=H / 2, basefocal=BASEFOCAL)
    cfg.read_config(CONFIG)
    p = em.EmParams.from_config(cfg, False)
    fl = torch.as_tensor(flows[:WINDOW], device=dev)
    Rs = so3_exp(torch.as_tensor(poses[:WINDOW, :3], device=dev))
    ts = torch.as_tensor(poses[:WINDOW, 3:6], device=dev)
    d0 = torch.as_tensor(depth0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    u = torch.rand((10, H, W), generator=gen, device=dev)
    jitter = 1.0 + 0.3 * (torch.rand((10, H, W), generator=gen, device=dev) - 0.5)
    cands_all = torch.cat([d0[None], d0[None] * jitter[:5], 1.0 / (u[:4] + 1e-5)]).contiguous()

    # priors: the frame-0 depth (identity pose: the stereo disparity slot
    # when D = 3), the frame-1 depth (pose 0 maps frame-0 points into
    # frame 1) and the frame-2 depth
    depth1 = plane_depth(K, Ts[1][:3, :3], Ts[1][:3, 3], planes, H, W)
    depth2 = plane_depth(K, Ts[2][:3, :3], Ts[2][:3, 3], planes, H, W)
    priors = torch.as_tensor(np.stack([depth0 * 1.01, depth1, depth2]), device=dev)
    dp_poses = np.stack([np.zeros(6, np.float32), poses[0],
                         T44_to_pose6(torch.as_tensor(Ts[2], dtype=torch.float32)).numpy()])
    dp_Rs = so3_exp(torch.as_tensor(dp_poses[:, :3], device=dev))
    dp_ts = torch.as_tensor(dp_poses[:, 3:6], device=dev)
    pconfs = torch.full((3, H, W), 0.9, device=dev)
    confs = torch.rand((3, H, W), generator=gen, device=dev)
    p_stereo = p._replace(disp_delta=1.0)  # slot 0 weighs as the disparity prior

    max_err = 0.0
    for active_n in (5, 3):
        rig = em.update_rigidness(d0, fl, Rs, ts, active_n, p).contiguous()
        track, tinb = em.precompute_obs_tracks(fl, active_n, p)
        for D in (0, 1, 2, 3):
            ps = None
            if D:
                ps = em.precompute_prior_samples(
                    d0, priors[:D], pconfs[:D], confs[:D], dp_Rs[:D], dp_ts[:D],
                    p_stereo if D == 3 else p,
                )
            for k in (1, 4, 10):
                cands = cands_all[:k].contiguous()
                args = (cands, track, tinb, rig, Rs, ts, active_n, p)
                got = cost_mod.normalize_cost(*cost_mod.cost_map_tracked(*args, prior_samples=ps))
                ref = cost_mod.normalize_cost(*cost_mod.cost_map_tracked_reference(*args, prior_samples=ps))
                torch.cuda.synchronize()
                fin = torch.isfinite(ref)
                if not torch.equal(fin, torch.isfinite(got)):
                    raise AssertionError(f"+inf pattern differs (K={k}, D={D}, active_n={active_n})")
                g, r = got[fin], ref[fin]
                bad = (torch.abs(g - r) > ATOL + RTOL * torch.abs(r)).sum().item()
                err = float(torch.abs(g - r).max()) if g.numel() else 0.0
                max_err = max(max_err, err)
                log(f"[kernel] K={k} D={D} active_n={active_n}: finite {int(fin.sum())}/{fin.numel()} "
                    f"max_abs_err {err:.3e} out-of-tol {bad}")
                if bad:
                    raise AssertionError(f"kernel disagrees with its plain version (K={k}, D={D}, active_n={active_n})")

    # timing at K=10, N=5, D=2 (CUDA events, median of 20)
    rig = em.update_rigidness(d0, fl, Rs, ts, WINDOW, p).contiguous()
    track, tinb = em.precompute_obs_tracks(fl, WINDOW, p)
    ps = em.precompute_prior_samples(d0, priors[:2], pconfs[:2], confs[:2], dp_Rs[:2], dp_ts[:2], p)
    args = (cands_all, track, tinb, rig, Rs, ts, WINDOW, p)

    def time_ms(fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(20):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    plain1 = time_ms(lambda: cost_mod.cost_map_tracked_reference(*args, prior_samples=ps))
    kern1 = time_ms(lambda: cost_mod.cost_map_tracked(*args, prior_samples=ps))
    kern2 = time_ms(lambda: cost_mod.cost_map_tracked(*args, prior_samples=ps))
    plain2 = time_ms(lambda: cost_mod.cost_map_tracked_reference(*args, prior_samples=ps))
    kern_ms, plain_ms = min(kern1, kern2), min(plain1, plain2)
    log(f"[kernel] K=10 N=5 D=2 median of 20: kernel {kern1:.4f} / {kern2:.4f} ms, "
        f"plain {plain1:.4f} / {plain2:.4f} ms (order plain, kernel, kernel, plain)")
    return max_err, kern_ms, plain_ms


def run_sequence(np, torch, scene, check=False):
    """Three consecutive windows with 0, 1 and 2 depth priors, driven the way
    the SLAM layer drives them (voldor_tpu/slam/system.py:535-575).

    Returns (cam->world poses of the 16 frames, per-window wall seconds,
    per-window EM iterations, bootstrap route)."""
    import voldor_tpu_torch
    from voldor_tpu_torch.ops.lie import T44_to_pose6, pose6_to_T44

    _, _, _, flows, _, _, _ = scene

    def T6(T):
        return T44_to_pose6(torch.as_tensor(np.asarray(T, np.float32))).numpy()

    Twc = np.eye(4, dtype=np.float32)  # world -> current camera
    frames_Tcw = []  # cam -> world per frame
    kf = []  # (fid, depth, conf) of earlier window starts, newest first
    walls, iters, route = [], [], None
    for wi in range(N_WINDOWS):
        fid = wi * WINDOW
        kw = {}
        if kf:
            use = kf[:2]
            kw["depth_priors"] = [d for _, d, _ in use]
            kw["depth_prior_pconfs"] = [c for _, _, c in use]
            kw["depth_prior_poses"] = np.stack(
                [T6(np.linalg.inv(Twc @ frames_Tcw[f])) for f, _, _ in use]
            )
            rel = Twc @ frames_Tcw[fid - 1]
            kw["poses_init"] = np.tile(T6(rel), (WINDOW, 1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        win = voldor_tpu_torch.voldor_dispatch(
            flows[fid:fid + WINDOW], FX, FY, W / 2, H / 2, basefocal=BASEFOCAL,
            config=CONFIG, pad_window_to=WINDOW, device="cuda", **kw,
        )
        res = win.collect()
        depth, conf = win.depth_host(), win.conf_host()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        eng = win.engine
        iters.append(eng.iters_cur)
        if wi == 0:
            route = eng.bootstrap_route
        if check:
            if res["n_registered"] != WINDOW:
                raise AssertionError(f"window {wi} registered {res['n_registered']} of {WINDOW}")
            for name, val in vars(eng).items():
                if isinstance(val, torch.Tensor) and val.device.type != "cuda":
                    raise AssertionError(f"engine tensor {name} is on {val.device}")
            if not (np.isfinite(depth).all() and np.isfinite(res["poses"]).all()):
                raise AssertionError(f"window {wi}: non-finite output")
        Tc = pose6_to_T44(torch.as_tensor(res["poses"])).numpy()
        for i in range(WINDOW):
            frames_Tcw.append(np.linalg.inv(Twc))
            Twc = (Tc[i] @ Twc).astype(np.float32)
        kf.insert(0, (fid, depth, conf))
    frames_Tcw.append(np.linalg.inv(Twc))
    return np.stack(frames_Tcw), walls, iters, route


def make_slam(mode, flows, disps=None):
    """VOLDOR_SLAM on the card, configured as bench.py:411-425 (mono) and
    bench.py:171-182 (stereo) configure it."""
    from voldor_tpu_torch.slam.system import VOLDOR_SLAM

    slam = VOLDOR_SLAM(mode=mode, device="cuda")
    slam.use_image_info = False
    slam.voldor_user_config = ""
    if mode == "stereo":
        slam.set_cam_params(FX, FY, W / 2, H / 2, basefocal=BF_STEREO)
        slam.disps = list(disps)
        slam.disp_loader_pt = len(disps)
    else:
        slam.set_cam_params(FX, FY, W / 2, H / 2)
    slam.flows = [flows[i] for i in range(flows.shape[0])]
    slam.N_FRAMES = flows.shape[0] + 1
    slam.h, slam.w = H, W
    slam.flow_loader_pt = flows.shape[0]
    return slam


def check_window_covis(np, slam, handle, inputs):
    """A window's device covis / spakf_covis scores against the host gate
    (slam_utils.eval_covisibility) on the same maps and chained poses."""
    from voldor_tpu_torch.slam.slam_utils import T6_to_T44, eval_covisibility

    res = handle.collect()
    thresh = inputs["covis_spec"]["conf_thresh"]
    depth, conf = handle.depth_host(), handle.conf_host()
    spa = inputs["covis_spec"].get("spakf")
    if spa is not None:
        sdep = spa[0].cpu().numpy() * np.float32(spa[2])
        sconf = spa[1].cpu().numpy()
        M = np.asarray(spa[3], np.float32).astype(np.float64)
    T = np.eye(4)
    err = 0.0
    for i, p6 in enumerate(handle.engine.poses6[:res["n_registered"]].cpu().numpy()):
        T = T6_to_T44(p6).astype(np.float64) @ T
        pairs = [(res["covis"][i], eval_covisibility(depth, T, slam.K, conf > thresh))]
        if spa is not None:
            pairs.append((res["spakf_covis"][i], eval_covisibility(sdep, T @ M, slam.K, sconf > thresh)))
        for dev_v, host_v in pairs:
            err = max(err, abs(float(dev_v) - host_v))
            if not abs(float(dev_v) - host_v) <= COVIS_TOL:
                raise AssertionError(f"window at fid {inputs['fid']}, step {i + 1}: device covis "
                                     f"{float(dev_v):.7f} vs host {host_v:.7f}")
    return err


def run_slam_pass(np, torch, mode, flows, disps=None, check=False):
    """One pass of process_vo to the end of the sequence. Returns the SLAM
    object, the pass's wall seconds and its per-pass counts."""
    slam = make_slam(mode, flows, disps)
    dispatched = []
    dispatch_s = [0.0]
    dispatch = slam._vo_dispatch

    def counting_dispatch(inputs):
        t = time.perf_counter()
        handle = dispatch(inputs)
        dispatch_s[0] += time.perf_counter() - t
        dispatched.append((handle, inputs))
        return handle

    slam._vo_dispatch = counting_dispatch
    steps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        fid = slam.fid_cur
        if not slam.process_vo():
            break
        steps.append(slam.fid_cur - fid)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    consumed = [(h, i) for h, i in dispatched if h._res is not None]
    stats = dict(
        windows=len(dispatched), flushes=len(dispatched) - len(consumed),
        keyframes=len(slam.kf_ids), vo_steps=steps,
        em_iters=sum(int(h.engine._st_scalars[1]) for h, _ in dispatched),
        priors=[h.engine.n_depth_priors for h, _ in dispatched],  # D per window
        dispatch_s=dispatch_s[0],
    )
    if check:
        if len(slam.frames) != flows.shape[0] + 1:
            raise AssertionError(f"{mode}: {len(slam.frames)} frames, expected {flows.shape[0] + 1}")
        for h, _ in dispatched:
            for name, val in vars(h.engine).items():
                if isinstance(val, torch.Tensor) and val.device.type != "cuda":
                    raise AssertionError(f"{mode}: engine tensor {name} is on {val.device}")
        for fid, f in enumerate(slam.frames):
            for t in (f.depth_dev, f.conf_dev):
                if t is not None and t.device.type != "cuda":
                    raise AssertionError(f"{mode}: frame {fid} map is on {t.device}")
            if not np.isfinite(f.Tcw).all():
                raise AssertionError(f"{mode}: frame {fid} pose is not finite")
        stats["covis_max_err"] = max(check_window_covis(np, slam, h, i) for h, i in consumed)
    return slam, dt, stats


def phase_slam(np, torch, mode, flows, gt, disps=None, n_timed=3):
    """slam-mono / slam-stereo: one checked pass with the launches counted,
    then n_timed timed passes. Returns (launches, median frames/s, ATE)."""
    from voldor_tpu_torch.ops import cost as cost_mod
    from voldor_tpu_torch.utils.evaluation import ate_rmse

    with_scale = mode == "mono"  # stereo is metric: no scale alignment
    extent = float(np.linalg.norm(gt[:, :3, 3] - gt[0, :3, 3], axis=1).max())
    cost_mod.cost_kernel_launches = 0
    slam, dt0, st = run_slam_pass(np, torch, mode, flows, disps, check=True)
    launches = cost_mod.cost_kernel_launches
    ate = ate_rmse(np.stack([f.Tcw for f in slam.frames]).astype(np.float64), gt, with_scale=with_scale)
    log(f"[slam-{mode}] checked pass: {len(slam.frames)} frames in {dt0:.4f} s; windows dispatched "
        f"{st['windows']}, pipeline flushes {st['flushes']}, keyframes {st['keyframes']} {slam.kf_ids}, "
        f"vo_steps {st['vo_steps']}, depth priors per window {st['priors']}; "
        f"EM iterations {st['em_iters']}, cost kernel launches {launches}; "
        f"device covis vs host eval_covisibility max abs err {st['covis_max_err']:.3e} "
        f"(tol {COVIS_TOL:g})")
    log(f"[slam-{mode}] {'Sim3' if with_scale else 'metric'} ATE {ate:.6f} vs gate "
        f"{0.02 * extent:.6f} (extent {extent:.4f})")
    if launches < 8 * st["em_iters"]:
        raise AssertionError(f"{mode}: cost kernel launched {launches} times, "
                             f"expected >= {8 * st['em_iters']}")
    if not ate < 0.02 * extent:
        raise AssertionError(f"{mode}: trajectory fails the ATE gate")
    n_frames = flows.shape[0] + 1
    dts = []
    for _ in range(n_timed):
        slam, dt, st = run_slam_pass(np, torch, mode, flows, disps)
        ate_t = ate_rmse(np.stack([f.Tcw for f in slam.frames]).astype(np.float64), gt,
                         with_scale=with_scale)
        log(f"[slam-{mode}] timed pass: {n_frames / dt:.4f} frames/s, pipeline {dt:.4f} s "
            f"({st['dispatch_s']:.4f} s inside voldor_dispatch); windows "
            f"{st['windows']}, flushes {st['flushes']}, keyframes {st['keyframes']}, "
            f"vo_steps {st['vo_steps']}, EM iterations {st['em_iters']}, ATE {ate_t:.6f}")
        if not ate_t < 0.02 * extent:
            raise AssertionError(f"{mode}: timed pass fails the ATE gate")
        dts.append(dt)
    med = statistics.median(dts)
    log(f"[slam-{mode}] median of {n_timed}: {n_frames / med:.4f} frames/s ({med:.4f} s per pass)")
    return launches, n_frames / med, ate


def main():
    import numpy as np
    import torch

    smi = phase_device(torch)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import voldor_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from voldor_tpu_torch.ops import cost as cost_mod
    from voldor_tpu_torch.utils.evaluation import ate_rmse
    from voldor_tpu_torch.vo import engine as engine_mod

    t0 = time.perf_counter()
    cost_mod.build()
    log(f"[build] nvcc {' '.join(cost_mod.NVCC_FLAGS)}: "
        f"{cost_mod.build_seconds if cost_mod.build_seconds is not None else 0.0:.2f} s "
        f"(load {time.perf_counter() - t0:.2f} s)")

    # the bench's 24-flow scene; the VO windows of phase 4 take its first
    # 15 flows (the pose draws are sequential, so they are the same)
    scene = build_scene(np, torch, SLAM_FLOWS)
    max_err, kern_ms, plain_ms = phase_kernel(np, torch, scene)

    # the slice, counted: every launch from here on is the main path's
    cost_mod.cost_kernel_launches = 0
    est, walls0, iters, route = run_sequence(np, torch, scene, check=True)
    launches = cost_mod.cost_kernel_launches
    log(f"[slice] bootstrap route: {route}; EM iterations per window {iters}; "
        f"cost kernel launches {launches}; cold wall s {[round(x, 4) for x in walls0]}")
    if launches < 8 * sum(iters):
        raise AssertionError(f"cost kernel launched {launches} times, expected >= {8 * sum(iters)}")
    gt = np.linalg.inv(scene[5][:N_WINDOWS * WINDOW + 1])  # cam -> world, frames 0..15
    extent = float(np.linalg.norm(gt[:, :3, 3] - gt[0, :3, 3], axis=1).max())
    ate = ate_rmse(est.astype(np.float64), gt, with_scale=True)
    log(f"[slice] Sim3 ATE {ate:.6f} vs gate {0.02 * extent:.6f} (extent {extent:.4f})")
    if not ate < 0.02 * extent:
        raise AssertionError("trajectory fails the Sim3-ATE gate")

    reps = [run_sequence(np, torch, scene)[1] for _ in range(3)]
    med = [statistics.median(r[i] for r in reps) for i in range(N_WINDOWS)]
    log(f"[times] window wall s (median of 3, warm; 0/1/2 priors): {[round(x, 4) for x in med]}")

    # fb_smooth's share of one window: synchronized timers around its calls
    fb_time = [0.0]

    def timed(fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            fb_time[0] += time.perf_counter() - t
            return out
        return wrapper

    # every fb_smooth call of a depth round goes through this one name
    # (fb_smooth_masked calls it too)
    orig = engine_mod.fb_smooth
    engine_mod.fb_smooth = timed(orig)
    try:
        _, walls_fb, _, _ = run_sequence(np, torch, scene)
    finally:
        engine_mod.fb_smooth = orig
    log(f"[times] fb_smooth over the 3 windows: {fb_time[0]:.4f} s of {sum(walls_fb):.4f} s "
        f"({100.0 * fb_time[0] / sum(walls_fb):.1f}%)")

    # the SLAM layer on the card: mono, then stereo with disparity
    # bf / depth (bench.py:116-154)
    from synthetic import plane_depth

    K, planes, _, flows, _, Ts, _ = scene
    gt = np.linalg.inv(Ts)  # cam -> world, frames 0..24
    launches_mono, fps_mono, ate_mono = phase_slam(np, torch, "mono", flows, gt, n_timed=3)
    disps = [(BF_STEREO / plane_depth(K, Ts[k][:3, :3], Ts[k][:3, 3], planes, H, W)).astype(np.float32)
             for k in range(SLAM_FLOWS)]
    launches_st, fps_st, ate_st = phase_slam(np, torch, "stereo", flows, gt, disps=disps, n_timed=1)
    log(f"[slam] mono {fps_mono:.4f} frames/s (Sim3 ATE {ate_mono:.6f}), stereo {fps_st:.4f} "
        f"frames/s (metric ATE {ate_st:.6f}); cost kernel launches: windows {launches}, "
        f"mono pass {launches_mono}, stereo pass {launches_st}")
    launches += launches_mono + launches_st

    log(f"[device] {smi}")
    log(json.dumps({"kernels": [{
        "name": "cost_map_tracked",
        "route": "cuda",
        "source": "voldor_tpu_torch/csrc/cost_kernel.cu",
        "replaces": "voldor_tpu/ops/pallas_cost.py:33",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
