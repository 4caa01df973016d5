"""Camera-pose step: P3P correspondence collection, batched LambdaTwist
solve, meanshift mode fusion and the robust-Gaussian refit (port of
``voldor_tpu/vo/pose_step.py``).

Ported: ``collect_p3p_instances`` :37 (traced collect; EM iteration 1 of
the hybrid sweep), ``collect_p3p_instances_all`` :166 (the traced collect of
every window frame in one pass, for the batched sweep),
``collect_p3p_instances_obs`` :290 (gather-free collect), the minimal-solver
registry ``_get_batch_p4p`` :398 (LambdaTwist or AP3P), ``_pose_step_core``
:408 with its single-frame wrapper ``optimize_camera_pose`` :598,
``_cameras_window_core`` :639 (sequential sweep) and
``_cameras_window_jacobi_core`` :740 (batched sweep). The window sweep's
``lax.cond``/``fori_loop`` become host control flow. Random draws come from
a ``torch.Generator`` through the ``draw_*`` helpers of each op.

The sweeps collect through ``ops/pose_collect.py:pose_collect``: on the
card one kernel launch a collect, on the CPU the plain
``collect_p3p_instances`` / ``collect_p3p_instances_obs`` below.
``collect_p3p_instances_all`` (``pose_collect_mode="traced"``) has no
kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from voldor_tpu_torch.ops import ap3p, lie, p3p
from voldor_tpu_torch.ops.chain_trace import _backproject, _pixel_grid, _transform
from voldor_tpu_torch.ops.image import bilinear_sample
from voldor_tpu_torch.ops.meanshift import draw_meanshift_trials, meanshift
from voldor_tpu_torch.ops.p3p import draw_p4p_indices
from voldor_tpu_torch.ops.pose_collect import pose_collect
from voldor_tpu_torch.ops.robust_gaussian import fit_robust_gaussian
from voldor_tpu_torch.utils.profiling import device_sync, host_read
from voldor_tpu_torch.vo.em import EmParams


class PoseStepResult(NamedTuple):
    poses6: torch.Tensor  # (N, 6): row active_idx updated
    pose_covars: torch.Tensor  # (N, 6, 6)
    pose_density: torch.Tensor
    pose_sample_count: torch.Tensor  # int32
    n_points: torch.Tensor  # int32
    success: torch.Tensor  # bool


class CameraWindowResult(NamedTuple):
    poses6: torch.Tensor  # (N, 6)
    pose_covars: torch.Tensor  # (N, 6, 6)
    pose_densities: torch.Tensor  # (N,)
    pose_sample_counts: torch.Tensor  # (N,) int32
    rigidness_densities: torch.Tensor  # (N,)
    n_flows_new: int
    truncated: bool


def collect_p3p_instances(
    depth, flows, rigidness, Rs, ts, active_idx: int, p: EmParams, *,
    rigidness_threshold, rigidness_sum_threshold, sample_min_depth,
    sample_max_depth, max_trace_on_flow: int, sample_stride: int = 1,
):
    """Per-pixel (p2, p3, valid) for target frame ``active_idx``, tracing p2
    along the observed flows from the rigid trace start (``pose_step.py:37``).
    Returns (p2 (hs, ws, 2), p3 (hs, ws, 3), valid (hs, ws))."""
    N, h, w = rigidness.shape
    xs, ys = _pixel_grid(h, w, depth.device)
    if sample_stride > 1:
        s = sample_stride
        xs, ys = xs[::s, ::s], ys[::s, ::s]
        depth = depth[::s, ::s]
        rigidness = rigidness[:, ::s, ::s]
    hs, ws = xs.shape

    ok = (depth >= sample_min_depth) & ((sample_max_depth <= 0) | (depth <= sample_max_depth))
    rig_sum = rigidness.sum(dim=0)
    ok = ok & ~((rig_sum < rigidness_sum_threshold) & (rigidness_sum_threshold > N + 1))

    lo = max(0, active_idx - max_trace_on_flow + 1) if max_trace_on_flow > 0 else 0
    prod = torch.ones((hs, ws), dtype=torch.float32, device=depth.device)
    n_trace = torch.zeros((hs, ws), dtype=torch.int32, device=depth.device)
    alive = torch.ones((hs, ws), dtype=torch.bool, device=depth.device)
    for i in range(N):
        f = active_idx - i
        if not (f >= lo and f >= 0):
            break  # in_range is false from here on, so nothing changes
        prod_new = prod * rigidness[f]
        good = (prod_new > rigidness_threshold) & alive
        prod = torch.where(good, prod_new, prod)
        n_trace = n_trace + good.to(torch.int32)
        alive = good
    ok = ok & (n_trace > 0)

    trace_start = active_idx - n_trace + 1
    ox, oy, oz = _backproject(xs, ys, depth, p)
    px = torch.zeros_like(xs)
    py = torch.zeros_like(ys)
    oob = torch.zeros((hs, ws), dtype=torch.bool, device=depth.device)
    for i in range(N):
        if i > active_idx:
            break  # no tracing or advancing past the target frame
        first = trace_start == i
        safe_oz = torch.where(torch.abs(oz) < 1e-12, 1e-12, oz)
        prj_x = (p.fx * ox + p.cx * safe_oz) / safe_oz
        prj_y = (p.fy * oy + p.cy * safe_oz) / safe_oz
        px = torch.where(first, prj_x, px)
        py = torch.where(first, prj_y, py)
        inb = (px > 0) & (px < w) & (py > 0) & (py < h)
        if i >= lo:
            d2 = bilinear_sample(flows[i], px, py)
            do_trace = i >= trace_start
            oob = oob | (do_trace & ~inb)
            px = torch.where(do_trace & inb, px + d2[..., 0], px)
            py = torch.where(do_trace & inb, py + d2[..., 1], py)
        if i < active_idx:
            ox, oy, oz = _transform(Rs[i], ts[i], ox, oy, oz)

    ok = ok & ~oob & (oz > sample_min_depth) & ((sample_max_depth <= 0) | (oz < sample_max_depth))
    p2 = torch.stack([px, py], dim=-1)
    p3 = torch.stack([ox, oy, oz], dim=-1)
    finite = torch.isfinite(p2).all(-1) & torch.isfinite(p3).all(-1)
    return p2, p3, ok & finite


def collect_p3p_instances_all(
    depth, flows, rigidness, Rs, ts, active_n: int, p: EmParams, *,
    rigidness_threshold, rigidness_sum_threshold, sample_min_depth,
    sample_max_depth, max_trace_on_flow: int, sample_stride: int = 1,
):
    """(p2, p3, valid) of the traced collect for EVERY window frame in one
    pass over the frames (``pose_step.py:166``): the 3D chain of target i is
    the shared point chain at step i, and its flow trace is one of at most
    ``max_trace_on_flow`` rolling trace buffers (a trace born at frame s
    serves every target whose trace starts at s), advanced by one batched
    flow gather per frame. Returns (p2 (N, hs, ws, 2), p3 (N, hs, ws, 3),
    valid (N, hs, ws))."""
    N, h, w = rigidness.shape
    dev = depth.device
    xs, ys = _pixel_grid(h, w, dev)
    if sample_stride > 1:
        s = sample_stride
        xs, ys = xs[::s, ::s], ys[::s, ::s]
        depth = depth[::s, ::s]
        rigidness = rigidness[:, ::s, ::s]
    hs, ws = xs.shape
    M = max(int(max_trace_on_flow), 1) if max_trace_on_flow > 0 else N

    ok0 = (depth >= sample_min_depth) & ((sample_max_depth <= 0) | (depth <= sample_max_depth))
    rig_sum = rigidness.sum(dim=0)
    ok0 = ok0 & ~((rig_sum < rigidness_sum_threshold) & (rigidness_sum_threshold > N + 1))

    ox, oy, oz = _backproject(xs, ys, depth, p)
    ages = torch.arange(M, device=dev)
    tpx = torch.zeros((M, hs, ws), dtype=torch.float32, device=dev)
    tpy = torch.zeros_like(tpx)
    toob = torch.zeros((M, hs, ws), dtype=torch.bool, device=dev)
    prods = torch.zeros_like(tpx)
    no_oob = torch.zeros((1, hs, ws), dtype=torch.bool, device=dev)
    outs = []
    for i in range(N):
        rig = rigidness[i]
        active = i < active_n
        # rigidness products over the last M frames ending at i
        prods = torch.cat([rig[None], prods[:-1] * rig[None]], dim=0)
        # a new trace is born at the projection of the chain point
        safe_oz = torch.where(torch.abs(oz) < 1e-12, 1e-12, oz)
        prj_x = (p.fx * ox + p.cx * safe_oz) / safe_oz
        prj_y = (p.fy * oy + p.cy * safe_oz) / safe_oz
        tpx = torch.cat([prj_x[None], tpx[:-1]], dim=0)
        tpy = torch.cat([prj_y[None], tpy[:-1]], dim=0)
        toob = torch.cat([no_oob, toob[:-1]], dim=0)
        # every live trace advances along the observed flow
        inb = (tpx > 0) & (tpx < w) & (tpy > 0) & (tpy < h)
        toob = toob | ~inb
        if active:
            obs = bilinear_sample(flows[i], tpx, tpy)
            tpx = torch.where(inb, tpx + obs[..., 0], tpx)
            tpy = torch.where(inb, tpy + obs[..., 1], tpy)
        # target i takes the trace buffer of age n_trace - 1
        alive = (prods > rigidness_threshold) & (ages <= i)[:, None, None]
        n_trace = torch.cumprod(alive.to(torch.int32), dim=0).sum(dim=0)
        sel = torch.clamp(n_trace - 1, 0, M - 1)
        onehot = ages[:, None, None] == sel[None]
        p2x = torch.where(onehot, tpx, 0.0).sum(dim=0)
        p2y = torch.where(onehot, tpy, 0.0).sum(dim=0)
        oob = (onehot & toob).any(dim=0)
        finite = (
            torch.isfinite(p2x) & torch.isfinite(p2y)
            & torch.isfinite(ox) & torch.isfinite(oy) & torch.isfinite(oz)
        )
        valid = (
            ok0 & active & (n_trace > 0) & ~oob & finite
            & (oz > sample_min_depth)
            & ((sample_max_depth <= 0) | (oz < sample_max_depth))
        )
        outs.append((p2x, p2y, ox, oy, oz, valid))
        ox, oy, oz = _transform(Rs[i], ts[i], ox, oy, oz)
    p2x, p2y, p3x, p3y, p3z, valid = (torch.stack(c) for c in zip(*outs))
    return torch.stack([p2x, p2y], dim=-1), torch.stack([p3x, p3y, p3z], dim=-1), valid


def collect_p3p_instances_obs(
    depth, obs_track, obs_tinb, rigidness, Rs, ts, active_n: int, p: EmParams, *,
    rigidness_threshold, rigidness_sum_threshold, sample_min_depth,
    sample_max_depth, max_trace_on_flow: int, sample_stride: int = 1,
):
    """All-frames (p2, p3, valid) from precomputed observed tracks — no flow
    gathers (``pose_step.py:290``). Returns (p2 (N, hs, ws, 2), p3 (N, hs,
    ws, 3), valid (N, hs, ws))."""
    N, h, w = rigidness.shape
    tx, ty, obx, oby = obs_track
    xs, ys = _pixel_grid(h, w, depth.device)
    if sample_stride > 1:
        s = sample_stride
        xs, ys = xs[::s, ::s], ys[::s, ::s]
        depth = depth[::s, ::s]
        rigidness = rigidness[:, ::s, ::s]
        tx, ty = tx[:, ::s, ::s], ty[:, ::s, ::s]
        obx, oby = obx[:, ::s, ::s], oby[:, ::s, ::s]
        obs_tinb = obs_tinb[:, ::s, ::s]
    hs, ws = xs.shape
    M = max(int(max_trace_on_flow), 1) if max_trace_on_flow > 0 else N

    ok0 = (depth >= sample_min_depth) & ((sample_max_depth <= 0) | (depth <= sample_max_depth))
    rig_sum = rigidness.sum(dim=0)
    ok0 = ok0 & ~((rig_sum < rigidness_sum_threshold) & (rigidness_sum_threshold > N + 1))

    p2x = tx + obx
    p2y = ty + oby
    cum_inb = torch.cumprod(obs_tinb.to(torch.int32), dim=0) > 0

    ox, oy, oz = _backproject(xs, ys, depth, p)
    ages = torch.arange(M, device=depth.device)
    prods = torch.zeros((M, hs, ws), dtype=torch.float32, device=depth.device)
    cum_rig_ok = torch.ones((hs, ws), dtype=torch.bool, device=depth.device)
    outs = []
    for i in range(N):
        rig = rigidness[i]
        prods = torch.cat([rig[None], prods[:-1] * rig[None]], dim=0)
        alive = (prods > rigidness_threshold) & (ages <= i)[:, None, None]
        n_trace = torch.cumprod(alive.to(torch.int32), dim=0).sum(dim=0)
        cum_rig_ok = cum_rig_ok & ((rig > rigidness_threshold) | (i >= active_n))
        valid = (
            ok0 & (i < active_n) & (n_trace > 0) & cum_rig_ok
            & (oz > sample_min_depth)
            & ((sample_max_depth <= 0) | (oz < sample_max_depth))
            & torch.isfinite(ox) & torch.isfinite(oy) & torch.isfinite(oz)
        )
        outs.append((ox, oy, oz, valid))
        ox, oy, oz = _transform(Rs[i], ts[i], ox, oy, oz)
    p3x, p3y, p3z, valid = (torch.stack(c) for c in zip(*outs))
    valid = valid & cum_inb & torch.isfinite(p2x) & torch.isfinite(p2y)
    return torch.stack([p2x, p2y], dim=-1), torch.stack([p3x, p3y, p3z], dim=-1), valid


def _collect_kw(hp):
    return dict(
        rigidness_threshold=hp["rigidness_threshold"],
        rigidness_sum_threshold=hp["rigidness_sum_threshold"],
        sample_min_depth=hp["sample_min_depth"],
        sample_max_depth=hp["sample_max_depth"],
        max_trace_on_flow=hp["max_trace_on_flow"],
        sample_stride=hp["pose_sample_stride"],
    )


def _get_batch_p4p(minimal_solver: str):
    """Minimal-solver registry (``pose_step.py:398``; --lambdatwist 1/0,
    geometry.cpp:149-153). Both solvers take the same 4-subset indices."""
    if minimal_solver == "lambdatwist":
        return p3p.solve_batch_p4p
    if minimal_solver == "ap3p":
        return ap3p.solve_batch_p4p_ap3p
    raise ValueError(f"unknown minimal_solver {minimal_solver!r}")


def _p4p_pool(minimal_solver: str, p2s, p3s, valid, idx, p: EmParams, rs: float):
    """The hypotheses ``idx`` as the meanshift pool: (pool (B, n, 6) =
    [rvec * rs, t], pool_valid (B, n) float32 0 / 1). LambdaTwist's kernel
    writes the pool directly (``p3p.solve_batch_p4p_pool``)."""
    if minimal_solver == "lambdatwist":
        return p3p.solve_batch_p4p_pool(p2s, p3s, valid, idx, p.fx, p.fy, p.cx, p.cy, rs)
    rvecs, tvecs, ok = _get_batch_p4p(minimal_solver)(p2s, p3s, valid, idx, p.fx, p.fy, p.cx, p.cy)
    return torch.cat([rvecs * rs, tvecs], dim=-1), ok.to(torch.float32)


def _solve_and_fuse(p2s, p3s, valid, ms_init, successive, rg_refine: bool, gen, p: EmParams, hp):
    """P4P pool -> meanshift -> optional robust-Gaussian refit, batched over
    the leading dim B. p2s (B, M, 2), p3s (B, M, 3), valid (B, M), ms_init
    (B, 6) poses, successive (B,) bool. On the card each of the three is
    one kernel launch, and nothing here reads the device from the host.

    Returns (pose6 (B, 6), covar (B, 6, 6), density (B,), sample_count
    (B,), n_points (B,), success (B,))."""
    solver = hp.get("minimal_solver", "lambdatwist")
    n_points = valid.sum(dim=-1).to(torch.int32)
    idx = draw_p4p_indices(gen, valid, hp["n_poses_to_sample"])
    rs = hp["meanshift_rvec_scale"]
    pool, pool_valid = _p4p_pool(solver, p2s, p3s, valid, idx, p, rs)
    sample_count = pool_valid.sum(dim=-1).to(torch.int32)

    init = torch.cat([ms_init[:, :3] * rs, ms_init[:, 3:6]], dim=-1)
    trials = draw_meanshift_trials(gen, pool_valid, hp["meanshift_max_init_trials"])
    ms = meanshift(
        pool, pool_valid, hp["meanshift_kernel_var"], init, successive, trials,
        epsilon=hp["meanshift_epsilon"], max_iters=hp["meanshift_max_iters"],
        good_init_confidence=hp["meanshift_good_init_confidence"],
    )
    s = hp["rg_pose_scaling"]
    B = valid.shape[0]
    eye = torch.eye(6, dtype=torch.float32, device=valid.device)
    covar0 = (eye * (hp["meanshift_kernel_var"] * s * s)).expand(B, 6, 6)
    unscale = torch.ones(6, dtype=torch.float32, device=valid.device)
    unscale[:3] = 1.0 / rs  # a fill on the device: no copy from the host
    if rg_refine:
        rg = fit_robust_gaussian(
            pool * s, pool_valid, ms.mean * s, covar0,
            trunc_sigma=hp["rg_trunc_sigma"], covar_reg_lambda=hp["rg_covar_reg_lambda"],
            epsilon=hp["rg_epsilon"], max_iters=hp["rg_max_iters"],
        )
        covar = (rg.covar / (s * s)) * unscale[:, None] * unscale[None, :]
        covar = torch.where(rg.reliable[:, None, None], covar, 0.0)
        mean_scaled = torch.where(rg.reliable[:, None], rg.mean / s, ms.mean)
        density = torch.where(rg.reliable, rg.density, ms.confidence)
    else:
        covar = torch.zeros((B, 6, 6), dtype=torch.float32, device=valid.device)
        mean_scaled = ms.mean
        density = ms.confidence
    pose6 = torch.cat([mean_scaled[:, :3] / rs, mean_scaled[:, 3:6]], dim=-1)
    success = (n_points >= 4) & (sample_count > 0) & torch.isfinite(pose6).all(dim=-1)
    return pose6, covar, density, sample_count, n_points, success


def _pose_step_core(
    depth, flows, rigidness, poses6, pose_covars, active_idx: int, successive_pose,
    rg_refine: bool, gen: torch.Generator, p: EmParams, *, collect_mode="traced",
    obs_track=None, obs_tinb=None, **hp,
) -> PoseStepResult:
    """One camera-pose step for frame ``active_idx`` (``pose_step.py:408``)."""
    Rs = lie.so3_exp(poses6[:, :3])
    ts = poses6[:, 3:6]
    ckw = _collect_kw(hp)
    if collect_mode == "obs" and obs_track is not None:
        p2all, p3all, vall = pose_collect(
            depth, rigidness, Rs, ts, active_idx + 1, p, obs_track=obs_track,
            obs_tinb=obs_tinb, **ckw,
        )
        p2map, p3map, vmap_ = p2all[active_idx], p3all[active_idx], vall[active_idx]
    else:
        p2map, p3map, vmap_ = pose_collect(
            depth, rigidness, Rs, ts, active_idx, p, flows=flows, **ckw
        )
    init = poses6[active_idx][None]
    pose6, covar, density, count, n_points, success = _solve_and_fuse(
        p2map.reshape(1, -1, 2), p3map.reshape(1, -1, 3), vmap_.reshape(1, -1),
        init, successive_pose.reshape(1), rg_refine, gen, p, hp,
    )
    pose6 = torch.where(success[:, None], pose6, init)[0]
    poses6_out = poses6.clone()
    poses6_out[active_idx] = pose6
    covars_out = pose_covars.clone()
    covars_out[active_idx] = torch.where(success[0], covar[0], pose_covars[active_idx])
    return PoseStepResult(
        poses6=poses6_out, pose_covars=covars_out, pose_density=density[0],
        pose_sample_count=count[0], n_points=n_points[0], success=success[0],
    )


def optimize_camera_pose(
    depth, flows, rigidness, poses6, pose_covars, active_idx: int, successive_pose,
    rg_refine: bool, seed: int, p: EmParams, **hp,
) -> PoseStepResult:
    """Single-frame wrapper over ``_pose_step_core`` (``pose_step.py:598``)
    with its own generator seeded from ``seed``, for tests and fine-grained
    callers; the engine runs whole window sweeps."""
    gen = torch.Generator(device=depth.device)
    gen.manual_seed(int(seed))
    return _pose_step_core(
        depth, flows, rigidness, poses6, pose_covars, active_idx,
        torch.as_tensor(successive_pose, device=depth.device), rg_refine, gen, p, **hp,
    )


def _cameras_window_core(
    depth, flows, rigidness, poses6, pose_covars, pose_densities, pose_sample_counts,
    n_flows: int, allow_trunc: bool, rg_refine: bool, gen: torch.Generator, p: EmParams,
    trunc_rigidness_density=0.05, trunc_sample_density=0.001, collect_mode="traced",
    obs_track=None, obs_tinb=None, **hp,
) -> CameraWindowResult:
    """Sequential (Gauss-Seidel) camera sweep with the truncation policy
    (``pose_step.py:639``, voldor.cpp:164-201)."""
    N = flows.shape[0]
    rig_dens = rigidness.reshape(N, -1).mean(dim=1)
    rig_dens_host = host_read("pose.rig_dens", torch.Tensor.tolist, rig_dens)
    densities = pose_densities.clone()
    counts = pose_sample_counts.clone()
    n_flows_cur, truncated = int(n_flows), False
    for i in range(N):
        if not (i < n_flows_cur and not truncated):
            continue
        attempt = (not allow_trunc) or rig_dens_host[i] > trunc_rigidness_density
        success = False
        if attempt:
            res = _pose_step_core(
                depth, flows, rigidness, poses6, pose_covars, i, counts[i] != 0,
                rg_refine, gen, p, collect_mode=collect_mode, obs_track=obs_track,
                obs_tinb=obs_tinb, **hp,
            )
            poses6, pose_covars = res.poses6, res.pose_covars
            success = host_read("pose.success", bool, res.success)
            if success:
                densities[i] = res.pose_density
                counts[i] = res.pose_sample_count
        trunc_now = (not success) or (
            allow_trunc
            and host_read("pose.trunc_density", float, densities[i]) < trunc_sample_density
        )
        if trunc_now:
            n_flows_cur, truncated = i, True
    return CameraWindowResult(
        poses6=poses6, pose_covars=pose_covars, pose_densities=densities,
        pose_sample_counts=counts, rigidness_densities=rig_dens,
        n_flows_new=n_flows_cur, truncated=truncated,
    )


def _cameras_window_jacobi_core(
    depth, flows, rigidness, poses6, pose_covars, pose_densities, pose_sample_counts,
    n_flows: int, allow_trunc: bool, rg_refine: bool, gen: torch.Generator, p: EmParams,
    trunc_rigidness_density=0.05, trunc_sample_density=0.001, collect_mode="traced",
    obs_track=None, obs_tinb=None, **hp,
) -> CameraWindowResult:
    """Batched (Jacobi) sweep: every frame's pose step against the pre-sweep
    poses, truncation applied to the batched outcomes (``pose_step.py:740``)."""
    N = flows.shape[0]
    rig_dens = rigidness.reshape(N, -1).mean(dim=1)
    Rs = lie.so3_exp(poses6[:, :3])
    ts = poses6[:, 3:6]
    if collect_mode == "obs" and obs_track is not None:
        p2, p3, valid = pose_collect(
            depth, rigidness, Rs, ts, n_flows, p, obs_track=obs_track, obs_tinb=obs_tinb,
            **_collect_kw(hp),
        )
    else:
        p2, p3, valid = collect_p3p_instances_all(
            depth, flows, rigidness, Rs, ts, n_flows, p, **_collect_kw(hp)
        )
    pose6_new, covar, density, count, _, success = _solve_and_fuse(
        p2.reshape(N, -1, 2), p3.reshape(N, -1, 3), valid.reshape(N, -1),
        poses6, pose_sample_counts != 0, rg_refine, gen, p, hp,
    )
    idx = torch.arange(N, device=depth.device)
    in_win = idx < n_flows
    with device_sync("pose.upload", depth.device):
        no_trunc = torch.tensor(not allow_trunc, device=depth.device)
    attempt = in_win & (no_trunc | (rig_dens > trunc_rigidness_density))
    dens_new = torch.where(success & attempt, density, pose_densities)
    passes = attempt & success & ~(allow_trunc & (dens_new < trunc_sample_density))
    fail = in_win & ~passes
    first_fail = host_read("pose.first_fail", int, torch.where(fail, idx, N).min())
    n_flows_new = min(int(n_flows), first_fail)
    apply = in_win & (idx <= first_fail) & attempt & success
    return CameraWindowResult(
        poses6=torch.where(apply[:, None], pose6_new, poses6),
        pose_covars=torch.where(apply[:, None, None], covar, pose_covars),
        pose_densities=torch.where(apply, density, pose_densities),
        pose_sample_counts=torch.where(apply, count, pose_sample_counts),
        rigidness_densities=rig_dens,
        n_flows_new=n_flows_new,
        truncated=n_flows_new < n_flows,
    )
