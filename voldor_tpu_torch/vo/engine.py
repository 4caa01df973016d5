"""The VO engine: init, bootstrap and the EM solve loop (port of
``voldor_tpu/vo/engine.py``).

The JAX package runs the whole EM solve as ONE jitted ``lax.while_loop``
(``_get_solve_fn`` :379-656). Here it is a host loop with the same
semantics: truncation with ``min_iters_after_trunc``, the ``max_iters_ext``
extension and the early stop, the hybrid sweep choice at iteration 1, the
anchored track carry, the solve-level prior-sample hoist with its final
confidence refresh, and the mono world-scale normalisation. Loop conditions
are host values (window size, iteration counters, the pose-convergence
scalar read once per iteration).

Every flow-fed depth round smooths its weights with the hand-written
fb_smooth kernel (``ops/fb_smooth.py``). With the 'tracked' or 'anchored'
cost it takes the batched proposal path, scored and accepted by the
hand-written CUDA cost kernel (``ops/cost.py``); with the reference's
'projected' cost it accepts one proposal map at a time, in torch ops. On
CPU tensors the kernels' plain versions run.

Besides the fused ``solve``, the engine keeps the JAX package's
reference-structured host loop (``solve_stepwise`` over
``optimize_cameras`` and ``_run_depth_round``), the legacy KITTI ground
estimate (``kitti_estimate_ground``), the deprecated in-engine
``resize_factor`` and ``save_result``.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from voldor_tpu_torch.config import VoldorConfig
from voldor_tpu_torch.ops import epipolar, lie
from voldor_tpu_torch.ops.cost import cost_map_accept, cost_map_score
from voldor_tpu_torch.ops.fb_smooth import fb_smooth
from voldor_tpu_torch.utils.profiling import count, device_sync, host_read, span
from voldor_tpu_torch.vo import em
from voldor_tpu_torch.vo.pose_step import _cameras_window_core, _cameras_window_jacobi_core

_FLT_EPS = 1.1920929e-07


def fb_smooth_masked(rigidness, active_n: int, fb_emm, fb_ncp):
    """FB-smooth only the active frames (maps are smoothed independently,
    so inactive ones are simply left as they are): the smoothed maps are
    written straight into the first planes of the result."""
    if active_n <= 0:
        return rigidness.clone()
    out = torch.empty_like(rigidness)
    out[active_n:] = rigidness[active_n:]
    fb_smooth(rigidness[:active_n], fb_emm, fb_ncp, out=out[:active_n])
    return out


def _depth_round_core(
    depth, flows, rigidness, poses6, priors, dp_pconfs, dp_confs, dp_poses6,
    active_n: int, params: em.EmParams, u, fb_emm, fb_ncp, range_factor, *,
    gstep, lwidth, mode, fb, rig_only, use_flows, use_priors, tracked,
    anchored=False, obs_track=None, obs_tinb=None, prior_samples=None,
    freeze_prior_confs=False,
):
    """One depth round (``engine.py:37-192``): optional FB smoothing of the
    weights, proposal rounds, then the rigidness refresh.

    u: the (n_rand, h, w) proposal uniforms. Flow-fed tracked/anchored
    rounds score and accept proposals in batches through the cost kernel
    (the initial cost in score mode, every batch in accept mode). Prior-only
    rounds, and every round of the 'projected' cost (``em.compute_cost_map``,
    not tracked), accept one proposal map at a time (``em.optimize_depth``
    in ``mode``, 'jump' or 'exact'), as the JAX package's unbatched path
    does. Returns (depth, rigidness, dp_confs) or, when anchored, (depth,
    rigidness, dp_confs, track, tinb).
    """
    Rs = lie.so3_exp(poses6[:, :3])
    ts = poses6[:, 3:6]
    dp_Rs = lie.so3_exp(dp_poses6[:, :3])
    dp_ts = dp_poses6[:, 3:6]

    if fb and not rig_only:
        if use_flows:
            rigidness = fb_smooth_masked(rigidness, active_n, fb_emm, fb_ncp)
        if use_priors:
            dp_confs = fb_smooth(dp_confs, fb_emm, fb_ncp)

    if not rig_only and not tracked:
        # the reference's cost: every candidate re-traced through the window
        f = flows if use_flows else None
        pr = priors if use_priors else None

        def cost_fn(d):
            return em.compute_cost_map(
                d, f, rigidness, Rs, ts, pr, dp_pconfs, dp_confs, dp_Rs, dp_ts, active_n, params
            )

        depth, _ = em.optimize_depth(
            depth, cost_fn(depth), cost_fn, u, global_prop_step=gstep,
            local_prop_width=lwidth, range_factor=range_factor, local_prop_mode=mode,
        )
    elif not rig_only:
        track = tinb = None
        if use_flows:
            if obs_track is not None:
                track, tinb = obs_track, obs_tinb
            elif anchored:
                _, track, tinb = em.update_rigidness_and_tracks(depth, flows, Rs, ts, active_n, params)
            else:
                track, tinb = em.precompute_obs_tracks(flows, active_n, params)
        pr_samples = None
        if use_priors:
            pr_samples = (
                prior_samples if prior_samples is not None
                else em.precompute_prior_samples(depth, priors, dp_pconfs, dp_confs, dp_Rs, dp_ts, params)
            )

        if use_flows:
            def accept_fn(depth, cost, cands, masks):
                return cost_map_accept(depth, cost, cands, masks, track, tinb, rigidness, Rs, ts,
                                       active_n, params, pr_samples)

            cost = cost_map_score(depth[None], track, tinb, rigidness, Rs, ts, active_n, params,
                                  pr_samples)[0]
            depth, cost = em.optimize_depth_batched(
                depth, cost, accept_fn, u, global_prop_step=gstep,
                local_prop_width=lwidth, range_factor=range_factor,
            )
        else:
            def cost_fn(d):
                return em.compute_cost_map_tracked(
                    d, track, tinb, rigidness, Rs, ts, pr_samples, active_n, params
                )

            depth, cost = em.optimize_depth(
                depth, cost_fn(depth), cost_fn, u, global_prop_step=gstep,
                local_prop_width=lwidth, range_factor=range_factor, local_prop_mode=mode,
            )

    track_out = tinb_out = None
    if use_flows:
        if anchored:
            rigidness, track_out, tinb_out = em.update_rigidness_and_tracks(
                depth, flows, Rs, ts, active_n, params
            )
        else:
            rigidness = em.update_rigidness(depth, flows, Rs, ts, active_n, params)
    if use_priors and not freeze_prior_confs:
        dp_confs = em.update_prior_confs(depth, priors, dp_confs, dp_Rs, dp_ts, params)
    if anchored:
        if track_out is None:
            track_out, tinb_out = obs_track, obs_tinb
        return depth, rigidness, dp_confs, track_out, tinb_out
    return depth, rigidness, dp_confs


def _depth_confidence(rigidness, dp_confs, active_n: int):
    """Mean of the active rigidness maps and the prior confidences
    (``engine.py:219``)."""
    total = rigidness[:active_n].sum(dim=0)
    if dp_confs.shape[0] > 0:
        total = total + dp_confs.sum(dim=0)
    return total / max(active_n + dp_confs.shape[0], 1)


def _normalize_world_scale_pure(poses6, depth, active_n: int):
    """Mono gauge fix: mean translation norm over the window -> 1."""
    active = torch.arange(poses6.shape[0], device=poses6.device) < active_n
    norms = torch.linalg.norm(poses6[:, 3:6], dim=-1) * active
    total = norms.sum()
    s = torch.where(total > 0, active_n / torch.clamp_min(total, 1e-30), 1.0)
    scale = torch.where(active[:, None], s, 1.0)
    poses6 = torch.cat([poses6[:, :3], poses6[:, 3:6] * scale], dim=-1)
    return poses6, depth * s


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) float32 weights of ``jax.image.resize(..., "linear")``
    along one axis: a triangle kernel, widened by the downscale factor
    (antialiased), normalised per output sample."""
    inv_scale = 1.0 / (n_out / n_in)
    sample_f = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None])
    x = x / max(inv_scale, 1.0)
    wts = torch.clamp_min(1.0 - x, 0.0)
    total = wts.sum(dim=0, keepdim=True)
    wts = torch.where(
        torch.abs(total) > 1000.0 * _FLT_EPS, wts / torch.where(total != 0, total, 1.0), 0.0
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], wts, 0.0)


def resize_linear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(h0, w0) or (n, h0, w0, c) float32 maps resized to (h, w) as
    ``jax.image.resize(x, shape, "linear")`` resizes them (the JAX engine's
    ``resize_factor``, ``engine.py:747-778``)."""
    h0, w0 = x.shape[1:3] if x.dim() == 4 else x.shape
    wy = _resize_weights(h0, h).to(x.device)
    wx = _resize_weights(w0, w).to(x.device)
    if x.dim() == 4:
        return torch.einsum("nhwc,hH,wW->nHWc", x, wy, wx)
    return torch.einsum("hw,hH,wW->HW", x, wy, wx)


def _round_through(x: torch.Tensor, dtype) -> torch.Tensor:
    """The JAX package's compressed upload, kept as a rounding cast."""
    return x.to(dtype).to(torch.float32)


def host_array(t: torch.Tensor) -> np.ndarray:
    """A float32 numpy copy of ``t`` on the host."""
    return np.array(t.cpu().numpy(), np.float32)


def _to_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    with device_sync("engine.upload", device):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)


def resolve_device(device=None) -> torch.device:
    """The device a caller asked for; with None, the CUDA device, and an
    error when there is none. The port never falls back to the CPU on its
    own: CPU callers pass device="cpu"."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)


class DeviceMap:
    """Device-resident prior map with a deferred scale multiply
    (``engine.py:254``): a previous window's output depth tensor plus the
    owning frame's map scale. The multiply and the compression cast run in
    ``_stack_maps``."""

    __slots__ = ("arr", "scale")

    def __init__(self, arr, scale: float = 1.0):
        self.arr = arr
        self.scale = float(scale)


_TRANSFER = {"bf16": torch.bfloat16, "f16": torch.float16}


def _stack_maps(lst, compress: str | None, device) -> torch.Tensor:
    """Stack (h, w) prior maps that may mix host numpy, tensors and
    DeviceMap entries into one (D, h, w) float32 tensor on ``device``
    (``engine.py:270``). A DeviceMap is multiplied by its scale in float32
    first; then every entry rounds through the compressed dtype ('bf16',
    'f16' or None), so the solve sees the same priors on both routes."""
    dt = _TRANSFER.get(compress)
    outs = []
    for x in lst:
        scale = 1.0
        if isinstance(x, DeviceMap):
            x, scale = x.arr, x.scale
        x = _to_tensor(x, device)
        if scale != 1.0:
            with device_sync("engine.upload", device):
                s = torch.tensor(scale, dtype=torch.float32, device=device)
            x = x * s
        outs.append(_round_through(x, dt) if dt is not None else x)
    return torch.stack(outs)


def _stack_flows(lst, compress: bool, device) -> torch.Tensor:
    """Stack per-transition (h, w, 2) flow maps that may mix host numpy and
    tensors (float16 or float32, as the SLAM layer's upload-ahead cache
    hands them in) into one (N, h, w, 2) float32 tensor on ``device``
    (``engine.py:326``). With ``compress`` every entry rounds through
    float16."""
    outs = []
    for x in lst:
        x = x.to(device) if isinstance(x, torch.Tensor) else _to_tensor(x, device)
        if compress:
            x = x.to(torch.float16)
        outs.append(x.to(torch.float32))
    return torch.stack(outs)


def pose_hp(cfg: VoldorConfig) -> dict:
    """The pose step's hyperparameters from a config (``engine.py:394-414``)."""
    return dict(
        rigidness_threshold=cfg.rigidness_threshold,
        rigidness_sum_threshold=cfg.rigidness_sum_threshold,
        sample_min_depth=cfg.pose_sample_min_depth,
        sample_max_depth=cfg.pose_sample_max_depth,
        max_trace_on_flow=cfg.max_trace_on_flow,
        pose_sample_stride=cfg.pose_sample_stride,
        n_poses_to_sample=cfg.n_poses_to_sample,
        meanshift_kernel_var=cfg.meanshift_kernel_var,
        meanshift_rvec_scale=cfg.meanshift_rvec_scale,
        meanshift_epsilon=cfg.meanshift_epsilon,
        meanshift_max_iters=cfg.meanshift_max_iters,
        meanshift_max_init_trials=cfg.meanshift_max_init_trials,
        meanshift_good_init_confidence=cfg.meanshift_good_init_confidence,
        rg_trunc_sigma=cfg.rg_trunc_sigma,
        rg_covar_reg_lambda=cfg.rg_covar_reg_lambda,
        rg_pose_scaling=cfg.rg_pose_scaling,
        rg_epsilon=cfg.rg_epsilon,
        rg_max_iters=cfg.rg_max_iters,
        minimal_solver="lambdatwist" if cfg.lambdatwist else "ap3p",
    )


def depth_kw(cfg: VoldorConfig) -> dict:
    """The depth rounds' switches from a config (``engine.py:415-427``)."""
    return dict(
        gstep=cfg.depth_global_prop_step,
        lwidth=cfg.depth_local_prop_width,
        mode=cfg.depth_local_prop_mode,
        fb=bool(cfg.fb_smooth),
        rig_only=not cfg.optimize_depth,
        tracked=cfg.depth_cost_mode in ("tracked", "anchored"),
        anchored=cfg.depth_cost_mode == "anchored",
    )


def _solve_loop(
    cfg: VoldorConfig, params: em.EmParams, hp: dict, dkw: dict, gen: torch.Generator,
    depth, flows, rigidness, priors, dp_pconfs, dp_confs, dp_poses6, poses6, covars,
    densities, counts, n_flows0: int,
) -> dict:
    """The EM solve loop from a loaded window (``_get_solve_fn``'s
    while_loop, ``engine.py:429-656``): camera sweeps with truncation, depth
    rounds, the mono gauge fix. ``hp``: the pose step's hyperparameters
    (``pose_hp``); ``dkw``: the depth rounds' switches (``depth_kw``). Every draw comes from ``gen``, in the
    order of the loop. Returns the JAX solve's state dict: depth,
    rigidness, dp_confs, poses6, covars, densities, counts, n_flows,
    iters_cur, iters_remain, rig_dens (and pose_delta, track, tinb where
    the JAX loop carries them)."""
    use_priors = priors.shape[0] > 0
    anchored = dkw["anchored"]
    N, h, w = flows.shape[:3]

    obs_track = obs_tinb = None
    if (dkw["tracked"] and not dkw["rig_only"]) or anchored or cfg.pose_collect_mode == "obs":
        obs_track, obs_tinb = em.precompute_obs_tracks(flows, n_flows0, params)

    freeze = use_priors and cfg.prior_sample_mode == "solve" and dkw["tracked"] and not dkw["rig_only"]
    pr_hoisted = None
    if freeze:
        dp_Rs0 = lie.so3_exp(dp_poses6[:, :3])
        dp_ts0 = dp_poses6[:, 3:6]
        pr_hoisted = em.precompute_prior_samples(
            depth, priors, dp_pconfs, dp_confs, dp_Rs0, dp_ts0, params
        )

    extend = cfg.max_iters_ext > cfg.max_iters
    early_stop = cfg.early_stop_min_iters > 0
    track_delta = extend or early_stop

    n_flows, iters_cur, iters_remain = n_flows0, 0, cfg.max_iters
    pose_delta = float("inf")
    track, tinb = obs_track, obs_tinb  # round 1 scores against frame-0 tracks
    rig_dens = torch.zeros(N, dtype=torch.float32, device=depth.device)

    while True:
        keep = iters_remain > 0
        if extend:
            keep = keep or (iters_cur < cfg.max_iters_ext and pose_delta > cfg.pose_converge_eps)
        if not (keep and n_flows > 0):
            break
        iters_cur += 1
        iters_remain -= 1
        allow_trunc = iters_cur > cfg.no_trunc_iters
        rg_ref = bool(cfg.rg_refine) and ((not cfg.rg_refine_last_only) or iters_remain == 0)
        cur_track = track if anchored else obs_track
        cur_tinb = tinb if anchored else obs_tinb
        sweep_args = (
            depth, flows, rigidness, poses6, covars, densities, counts, n_flows,
            allow_trunc, rg_ref, gen, params,
        )
        sweep_kw = dict(
            trunc_rigidness_density=cfg.trunc_rigidness_density,
            trunc_sample_density=cfg.trunc_sample_density, **hp,
        )
        jac_kw = dict(collect_mode=cfg.pose_collect_mode, obs_track=cur_track, obs_tinb=cur_tinb, **sweep_kw)
        if cfg.pose_window_sweep == "seq" or (cfg.pose_window_sweep == "hybrid" and iters_cur == 1):
            count("pose.sweep.seq")
            with span("pose.sweep"):
                cam = _cameras_window_core(*sweep_args, **sweep_kw)
        elif cfg.pose_window_sweep in ("jacobi", "hybrid"):
            count("pose.sweep.jacobi")
            with span("pose.sweep"):
                cam = _cameras_window_jacobi_core(*sweep_args, **jac_kw)
        else:
            raise ValueError(f"unknown pose_window_sweep {cfg.pose_window_sweep!r}")
        n_flows = cam.n_flows_new
        if cam.truncated:
            iters_remain = max(iters_remain, cfg.min_iters_after_trunc)
        u = em.draw_depth_uniforms(gen, cfg.depth_rand_samples, h, w, depth.device)
        with span("depth.round"):
            dr = _depth_round_core(
                depth, flows, rigidness, cam.poses6, priors, dp_pconfs, dp_confs,
                dp_poses6, n_flows, params, u, cfg.fb_emm,
                cfg.fb_no_change_prob, cfg.depth_range_factor,
                use_flows=True, use_priors=use_priors, obs_track=cur_track,
                obs_tinb=cur_tinb, prior_samples=pr_hoisted, freeze_prior_confs=freeze, **dkw,
            )
        if anchored:
            depth_, rigidness, dp_confs, track, tinb = dr
        else:
            depth_, rigidness, dp_confs = dr
        poses6_ = cam.poses6
        if cfg.norm_world_scale and not use_priors:
            poses6_, depth_ = _normalize_world_scale_pure(poses6_, depth_, n_flows)
        if track_delta:
            a = n_flows
            rot_d = torch.linalg.norm(poses6_[:a, :3] - poses6[:a, :3], dim=1)
            t_mag = torch.clamp_min(torch.linalg.norm(poses6_[:a, 3:6], dim=1), 1e-6)
            tr_d = torch.linalg.norm(poses6_[:a, 3:6] - poses6[:a, 3:6], dim=1) / t_mag
            pose_delta = (
                host_read("engine.pose_delta", float, (rot_d + tr_d).max()) if a > 0 else 0.0
            )
            iters_remain = max(iters_remain, 0)
        if early_stop:
            if pose_delta <= cfg.pose_converge_eps and iters_cur + 1 >= cfg.early_stop_min_iters:
                iters_remain = min(iters_remain, 1)
        depth, poses6 = depth_, poses6_
        covars, densities, counts = cam.pose_covars, cam.pose_densities, cam.pose_sample_counts
        rig_dens = cam.rigidness_densities

    if freeze:
        dp_confs = em.update_prior_confs(depth, priors, dp_confs, dp_Rs0, dp_ts0, params)
    st = dict(
        depth=depth, rigidness=rigidness, dp_confs=dp_confs, poses6=poses6, covars=covars,
        densities=densities, counts=counts, n_flows=n_flows, iters_cur=iters_cur,
        iters_remain=iters_remain, rig_dens=rig_dens,
    )
    if track_delta:
        st["pose_delta"] = pose_delta
    if anchored:
        st["track"], st["tinb"] = track, tinb
    return st


@dataclass
class VoldorEngine:
    """Device-resident EM state plus the solve-loop control flow."""

    cfg: VoldorConfig
    device: torch.device | str | None = None
    flows: torch.Tensor | None = None  # (N, h, w, 2)
    rigidness: torch.Tensor | None = None  # (N, h, w)
    depth: torch.Tensor | None = None  # (h, w)
    poses6: torch.Tensor | None = None  # (N, 6) [rvec, tvec]
    pose_covars: torch.Tensor | None = None  # (N, 6, 6)
    pose_densities_dev: torch.Tensor | None = None  # (N,)
    pose_sample_counts_dev: torch.Tensor | None = None  # (N,) int32
    pose_rigidness_densities: np.ndarray | None = None  # (N,) host
    priors: torch.Tensor | None = None  # (D, h, w)
    dp_pconfs: torch.Tensor | None = None
    dp_confs: torch.Tensor | None = None
    dp_poses6: torch.Tensor | None = None  # (D, 6)
    has_disparity: bool = False
    n_flows: int = 0
    n_flows_init: int = 0
    n_depth_priors: int = 0
    w: int = 0
    h: int = 0
    iters_cur: int = 0
    iters_remain: int = 0
    bootstrap_route: str | None = None  # 'cv2' or 'epipolar' once bootstrapped
    ground: tuple | None = None  # KittiGround, with kitti_estimate_ground
    gen: torch.Generator | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ------------------------------------------------------------------
    def init(
        self, flows, disparity=None, disparity_pconf=None, depth_priors=None,
        depth_prior_poses=None, depth_prior_pconfs=None, poses_init=None,
    ):
        """Load a window (``engine.py:706``). flows: (N, h, w, 2) array,
        tensor or a per-transition list. A disparity map (h, w) becomes the
        depth prior basefocal / disparity with the identity pose. Depth
        priors come with (D, 6) poses mapping frame-0 points into each
        prior camera; each prior map (and confidence) may be a numpy array,
        a tensor or a DeviceMap (a previous window's output)."""
        cfg = self.cfg
        dev = self.device
        if cfg.pose_window_sweep == "jacobi" and not cfg.silent:
            warnings.warn(
                "--pose_window_sweep jacobi is an ablation/testing mode; use 'hybrid' or 'seq'.",
                stacklevel=3,
            )
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(int(cfg.seed))

        rf = cfg.resize_factor
        if rf != 1.0:
            # deprecated upstream (the SLAM layer resizes): flows and the
            # disparity are resized here, the intrinsics scaled
            if isinstance(flows, (list, tuple)):
                raise ValueError(
                    "flow handle lists require resize_factor == 1 (resize is the SLAM layer's duty)"
                )
            flows = _to_tensor(flows, dev)
            n, h0, w0, _ = flows.shape
            flows = resize_linear(flows, int(h0 * rf), int(w0 * rf)) * rf
            cfg.fx *= rf
            cfg.fy *= rf
            cfg.cx *= rf
            cfg.cy *= rf

        compress = cfg.transfer_dtype == "float16"
        # an array, or per-transition entries mixing host numpy and tensors
        # (the SLAM layer's upload-ahead cache)
        self.flows = _stack_flows(list(flows), compress, dev)
        N, h, w = self.flows.shape[:3]
        self.n_flows = self.n_flows_init = N
        self.h, self.w = h, w
        self.iters_cur = 0
        self.iters_remain = cfg.max_iters

        self.rigidness = torch.ones((N, h, w), dtype=torch.float32, device=dev)
        self.poses6 = torch.zeros((N, 6), dtype=torch.float32, device=dev)
        if poses_init is not None:
            pi = _to_tensor(poses_init, dev)
            self.poses6[: pi.shape[0]] = pi
        self.pose_covars = torch.zeros((N, 6, 6), dtype=torch.float32, device=dev)
        self.pose_densities_dev = torch.zeros(N, dtype=torch.float32, device=dev)
        self.pose_sample_counts_dev = torch.zeros(N, dtype=torch.int32, device=dev)
        self.pose_rigidness_densities = np.zeros(N, np.float32)

        # slot 0 is the disparity prior (engine.py:770-785): depth bf/disp
        # seen from frame 0 itself
        prior_list, pconf_list, pose_list = [], [], []
        self.has_disparity = disparity is not None
        if disparity is not None:
            dp = cfg.basefocal / np.maximum(np.asarray(disparity, np.float32), 1e-12)
            if rf != 1.0:
                dp = resize_linear(_to_tensor(dp, dev), h, w) * rf
            prior_list.append(dp)
            pconf_list.append(
                np.ones((h, w), np.float32) if disparity_pconf is None
                else disparity_pconf
            )
            pose_list.append(np.zeros(6, np.float32))
        for i in range(0 if depth_priors is None else len(depth_priors)):
            prior_list.append(depth_priors[i])
            pconf_list.append(
                np.ones((h, w), np.float32) if depth_prior_pconfs is None
                else depth_prior_pconfs[i]
            )
            pose_list.append(np.asarray(depth_prior_poses[i], np.float32))

        D = len(prior_list)
        self.n_depth_priors = D
        if D > 0:
            self.priors = _stack_maps(prior_list, "bf16" if compress else None, dev)
            self.dp_pconfs = _stack_maps(pconf_list, "f16" if compress else None, dev)
            self.dp_confs = torch.ones((D, h, w), dtype=torch.float32, device=dev)
            with device_sync("engine.upload", dev):
                self.dp_poses6 = torch.as_tensor(np.stack(pose_list), device=dev)
            self.depth = self.priors[0].clone()
            if not self.has_disparity:
                self._run_depth_round(prior_only=True)  # fuse priors into the initial depth
        else:
            self.priors = torch.zeros((0, h, w), dtype=torch.float32, device=dev)
            self.dp_pconfs = torch.zeros((0, h, w), dtype=torch.float32, device=dev)
            self.dp_confs = torch.zeros((0, h, w), dtype=torch.float32, device=dev)
            self.dp_poses6 = torch.zeros((0, 6), dtype=torch.float32, device=dev)
            self.depth = torch.ones((h, w), dtype=torch.float32, device=dev)
        return self

    # ------------------------------------------------------------------
    def _params(self) -> em.EmParams:
        return em.EmParams.from_config(self.cfg, self.has_disparity)

    def _uniforms(self):
        return em.draw_depth_uniforms(self.gen, self.cfg.depth_rand_samples, self.h, self.w, self.device)

    def _run_depth_round(self, prior_only: bool = False, rigidness_only: bool = False):
        """One standalone depth round (``engine.py:1057``): the prior-fusion
        round of init, or a round of ``solve_stepwise``. Without carried
        track planes or hoisted prior samples, it anchors and samples at
        the round-start depth."""
        cfg = self.cfg
        use_flows = self.n_flows > 0 and not prior_only
        use_priors = self.n_depth_priors > 0
        if not use_flows and not use_priors:
            return
        kw = depth_kw(self.cfg)
        kw["rig_only"] = rigidness_only
        ret = _depth_round_core(
            self.depth, self.flows, self.rigidness, self.poses6, self.priors,
            self.dp_pconfs, self.dp_confs, self.dp_poses6, self.n_flows if use_flows else 0,
            self._params(), self._uniforms(), cfg.fb_emm, cfg.fb_no_change_prob,
            cfg.depth_range_factor, use_flows=use_flows, use_priors=use_priors, **kw,
        )
        self.depth, self.rigidness, self.dp_confs = ret[:3]

    # ------------------------------------------------------------------
    def bootstrap(self):
        """Monocular two-frame init (``engine.py:869``): OpenCV's 5-point
        LMedS on the host when cv2 is importable, else the batched 8-point
        path of ops/epipolar.py. The closed-form depth runs on the device."""
        cfg = self.cfg
        dev = self.device
        K_np = np.array([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1]], np.float64)
        K = torch.as_tensor(K_np, dtype=torch.float32, device=dev)
        R = t = None
        try:
            import cv2
        except ImportError:
            cv2 = None
        if cv2 is not None:
            cv2.setRNGSeed(int(cfg.seed))
            flow0 = host_read("engine.bootstrap", host_array, self.flows[0])
            h, w = flow0.shape[:2]
            step = max(1, round((h * w / 3000.0) ** 0.5))
            ys, xs = np.mgrid[0:h:step, 0:w:step]
            p1 = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float64)
            p2 = p1 + flow0[::step, ::step].reshape(-1, 2).astype(np.float64)
            try:
                E, mask = cv2.findEssentialMat(p1, p2, K_np, method=cv2.LMEDS)
                if E is not None and E.shape == (3, 3):
                    _, R_cv, t_cv, _ = cv2.recoverPose(E, p1, p2, K_np, mask=mask)
                    R = torch.as_tensor(R_cv, dtype=torch.float32, device=dev)
                    t = R @ torch.as_tensor(t_cv.ravel(), dtype=torch.float32, device=dev)
                    self.bootstrap_route = "cv2"
            except cv2.error:
                R = t = None  # degenerate flow: the 8-point path takes over
        if R is None:
            idx = epipolar.draw_epipolar_indices(self.gen, self.flows[0])
            R, t, _ = epipolar.estimate_pose_epipolar(self.flows[0], K, idx)
            self.bootstrap_route = "epipolar"
        self.depth = epipolar.estimate_depth_closed_form(self.flows[0], K, R, t)
        self.poses6[0] = torch.cat([lie.so3_log(R), t])

    # ------------------------------------------------------------------
    def solve(self, defer_host: bool = False) -> int:
        """The EM loop (voldor.cpp:130-149, ``engine.py:429-656``)."""
        if self.n_depth_priors == 0:
            self.bootstrap()
        st = _solve_loop(
            self.cfg, self._params(), pose_hp(self.cfg), depth_kw(self.cfg), self.gen,
            self.depth, self.flows, self.rigidness, self.priors, self.dp_pconfs, self.dp_confs,
            self.dp_poses6, self.poses6, self.pose_covars, self.pose_densities_dev,
            self.pose_sample_counts_dev, self.n_flows,
        )
        self.depth, self.rigidness, self.dp_confs = st["depth"], st["rigidness"], st["dp_confs"]
        self.poses6, self.pose_covars = st["poses6"], st["covars"]
        self.pose_densities_dev, self.pose_sample_counts_dev = st["densities"], st["counts"]
        self._st_scalars = (st["n_flows"], st["iters_cur"], st["rig_dens"])
        if defer_host:
            return -1
        self.finalize_host()
        return self.iters_cur

    def finalize_host(self, extra_fetch=()):
        """Copy the end-of-solve scalars (and the caller's extras) to the
        host, then run the host epilogue (the KITTI ground estimate).
        Returns the extras as numpy arrays, in order."""
        cfg = self.cfg
        n_flows, iters_cur, rig_dens = self._st_scalars
        self.n_flows = int(n_flows)
        self.iters_cur = int(iters_cur)
        self.iters_remain = 0
        self.pose_rigidness_densities[: rig_dens.shape[0]] = host_read(
            "engine.finalize", host_array, rig_dens)
        if cfg.kitti_estimate_ground:
            # legacy capability (voldor.cpp:146-147, 320-331)
            from voldor_tpu_torch.vo.kitti_ground import estimate_kitti_ground

            K = np.asarray([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1]], np.float32)
            self.ground = estimate_kitti_ground(
                self.depth, K, roi_frac=cfg.kitti_ground_roi,
                holo_width=cfg.kitti_ground_holo_width,
                ms_kernel_var=cfg.kitti_ground_meanshift_kernel_var,
            )
        return [host_read("engine.finalize", host_array, x) for x in extra_fetch]

    def solve_stepwise(self) -> int:
        """The reference-structured host loop (``engine.py:981``): one call
        per phase, a sequential camera sweep then a depth round per EM
        iteration, with no extension or early stop. For debugging and
        parity checks; ``solve`` is the fast path."""
        cfg = self.cfg
        if self.n_depth_priors == 0:
            self.bootstrap()
        while self.iters_remain > 0 and self.n_flows > 0:
            self.iters_cur += 1
            self.iters_remain -= 1
            self.optimize_cameras()
            self._run_depth_round(rigidness_only=not cfg.optimize_depth)
            if cfg.norm_world_scale and self.n_depth_priors == 0:
                self.poses6, self.depth = _normalize_world_scale_pure(
                    self.poses6, self.depth, self.n_flows
                )
        return self.iters_cur

    def optimize_cameras(self):
        """One sequential camera sweep with the truncation policy
        (``engine.py:999``, voldor.cpp:164-201)."""
        cfg = self.cfg
        allow_trunc = self.iters_cur > cfg.no_trunc_iters
        rg_refine = bool(cfg.rg_refine) and (not cfg.rg_refine_last_only or self.iters_remain == 0)
        res = _cameras_window_core(
            self.depth, self.flows, self.rigidness, self.poses6, self.pose_covars,
            self.pose_densities_dev, self.pose_sample_counts_dev, self.n_flows,
            allow_trunc, rg_refine, self.gen, self._params(),
            trunc_rigidness_density=cfg.trunc_rigidness_density,
            trunc_sample_density=cfg.trunc_sample_density, **pose_hp(self.cfg),
        )
        self.poses6, self.pose_covars = res.poses6, res.pose_covars
        self.pose_densities_dev = res.pose_densities
        self.pose_sample_counts_dev = res.pose_sample_counts
        rig_dens = res.rigidness_densities.cpu().numpy()
        self.pose_rigidness_densities[: rig_dens.shape[0]] = rig_dens
        if res.truncated:
            if not cfg.silent:
                print(f"truncated at camera {res.n_flows_new}")
            self.iters_remain = max(self.iters_remain, cfg.min_iters_after_trunc)
            self.n_flows = res.n_flows_new

    @property
    def poses(self) -> np.ndarray:
        """(N, 6) host copy of the window poses."""
        return self.poses6.cpu().numpy()

    @property
    def pose_covars_host(self) -> np.ndarray:
        return self.pose_covars.cpu().numpy()

    # ------------------------------------------------------------------
    def depth_confidence(self) -> np.ndarray:
        """Mean of active rigidness + prior-confidence maps."""
        if self.n_flows + self.n_depth_priors == 0:
            return np.zeros((self.h, self.w), np.float32)
        return _depth_confidence(self.rigidness, self.dp_confs, self.n_flows).cpu().numpy()


def save_result(engine: VoldorEngine, save_dir: str) -> None:
    """The artifact dump of VOLDOR::save_result (``engine.py:1119``,
    voldor.cpp:333-376): depth.npy and depth.png, one pose line per
    registered camera in camera_pose.txt, the normalised rigidness sum; with
    ``cfg.save_everything`` also each frame's rigidness map and flow
    visualisation."""
    os.makedirs(save_dir, exist_ok=True)
    depth = engine.depth.cpu().numpy()
    np.save(os.path.join(save_dir, "depth.npy"), depth)
    try:
        import cv2

        cv2.imwrite(os.path.join(save_dir, "depth.png"), depth)
    except ImportError:
        pass

    with open(os.path.join(save_dir, "camera_pose.txt"), "w") as f:
        poses = engine.poses
        for i in range(engine.n_flows):
            f.write(" ".join(f"{v:f}" for v in poses[i]) + "\n")

    rig = engine.rigidness.cpu().numpy()
    rig_sum = rig[: engine.n_flows].sum(axis=0) / max(engine.n_flows, 1)
    np.save(os.path.join(save_dir, "rigidness_sum.npy"), rig_sum)

    if engine.cfg.save_everything:
        from voldor_tpu_torch.utils.flow_io import vis_flow

        flows = engine.flows.cpu().numpy()
        for i in range(engine.n_flows_init):
            np.save(os.path.join(save_dir, f"rigidness-{i}.npy"), rig[i])
            np.save(os.path.join(save_dir, f"flow-viz-{i}.npy"), vis_flow(flows[i]))
    if not engine.cfg.silent:
        print(f"results saved to {save_dir}")
