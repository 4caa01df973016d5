"""EM core of the VO engine: rigidness updates, the tracked and the
projected Fisk cost maps and the PatchMatch-style depth update (port of
``voldor_tpu/vo/em.py``).

Geometry conventions are the JAX package's: ``depth`` lives in the frame-0
camera; pose f (Rs[f], ts[f]) maps frame-f points to frame f+1; flows[f]
maps pixels of frame f to frame f+1; depth-prior pose d maps frame-0
points into the prior's camera. ``active_n`` is a host int here (the JAX
solve carries it as a traced scalar).

Random draws are split from the functions that use them: the proposal
uniforms come in as a tensor (``draw_depth_uniforms``), so tests can feed
both packages the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from voldor_tpu_torch.ops import fisk
from voldor_tpu_torch.ops.chain_trace import (
    _backproject, _pixel_grid, _project_safe, chain_flow_terms, chain_trace,
)
from voldor_tpu_torch.ops.cost import cost_map_tracked_reference, normalize_cost
from voldor_tpu_torch.ops.image import bilinear_sample
from voldor_tpu_torch.utils.profiling import device_sync

MAXIMUM_DEPTH = 1e5


class EmParams(NamedTuple):
    """Scalar hyperparameters of the EM cost, as f32-rounded Python floats."""

    fx: float
    fy: float
    cx: float
    cy: float
    basefocal: float
    abs_resize_factor: float
    lam: float
    omega: float
    delta: float
    disp_delta: float  # <0 disables the disparity slot

    @classmethod
    def from_config(cls, cfg, has_disparity: bool):
        def f32(v):
            return float(np.float32(v))

        return cls(
            fx=f32(cfg.fx),
            fy=f32(cfg.fy),
            cx=f32(cfg.cx),
            cy=f32(cfg.cy),
            basefocal=f32(cfg.basefocal),
            abs_resize_factor=f32(cfg.abs_resize_factor),
            lam=f32(cfg.lambda_),
            omega=f32(cfg.omega),
            delta=f32(cfg.delta),
            disp_delta=f32(cfg.disp_delta if has_disparity else -1.0),
        )


def prior_terms(depth, priors, dp_Rs, dp_ts, p: EmParams):
    """Frame-0 points projected into each depth-prior camera.

    Returns (oz, px, py, inb), each (D, h, w) (``em.py:145``).
    """
    h, w = depth.shape
    xs, ys = _pixel_grid(h, w, depth.device)
    ox, oy, oz0 = _backproject(xs, ys, depth, p)
    R = dp_Rs[:, :, :, None, None]  # (D, 3, 3, 1, 1)
    t = dp_ts[:, :, None, None]
    nx = R[:, 0, 0] * ox + R[:, 0, 1] * oy + R[:, 0, 2] * oz0 + t[:, 0]
    ny = R[:, 1, 0] * ox + R[:, 1, 1] * oy + R[:, 1, 2] * oz0 + t[:, 1]
    nz = R[:, 2, 0] * ox + R[:, 2, 1] * oy + R[:, 2, 2] * oz0 + t[:, 2]
    px, py = _project_safe(nx, ny, nz, p)
    inb = (nz > 0) & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    return nz, px, py, inb


def _sample_stack(maps, px, py):
    """bilinear_sample of each (h, w) map d at (px[d], py[d])."""
    return torch.stack([bilinear_sample(maps[d], px[d], py[d]) for d in range(maps.shape[0])]) \
        if maps.shape[0] > 0 else torch.zeros_like(px)


def precompute_obs_tracks(flows, active_n: int, p: EmParams):
    """Depth-independent observed-flow track through the window
    (``em.py:169``): P_0 = grid, P_{f+1} = P_f + flows[f](P_f).

    Returns ((track_x, track_y, obs_x, obs_y) each (N, h, w), inb (N, h, w)).
    """
    N, h, w = flows.shape[0], flows.shape[1], flows.shape[2]
    xs, ys = _pixel_grid(h, w, flows.device)
    px, py = xs, ys
    outs = []
    for f in range(N):
        active = f < active_n
        inb = (px >= 0) & (px < w) & (py >= 0) & (py < h) & active
        if active:
            obs = bilinear_sample(flows[f], px, py)
            obx, oby = obs[..., 0], obs[..., 1]
        else:
            obx = oby = torch.zeros_like(px)
        outs.append((px, py, obx, oby, inb))
        px = torch.where(inb, px + obx, px)
        py = torch.where(inb, py + oby, py)
    tx, ty, obx, oby, inb = (torch.stack(c) for c in zip(*outs))
    return (tx, ty, obx, oby), inb


def compute_cost_map_tracked(
    depth, track, track_inb, rigidness, Rs, ts, prior_samples, active_n: int, p: EmParams
):
    """Normalized gather-free Fisk cost of one candidate depth map
    (``em.py:208``). The math is the batched plain version in ops/cost.py."""
    cs, ws = cost_map_tracked_reference(
        depth[None], track, track_inb, rigidness, Rs, ts, active_n, p,
        prior_samples=prior_samples,
    )
    return normalize_cost(cs, ws)[0]


def prior_cost_sums(depth, prior_samples, p: EmParams):
    """Raw (cost_sum, weight_sum) of the depth-prior arm for one candidate
    (``em.py:271``)."""
    return tuple(
        a[0] for a in cost_map_tracked_reference(
            depth[None], None, None, None, None, None, 0, p, prior_samples=prior_samples
        )
    )


def precompute_prior_samples(depth, priors, dp_pconfs, dp_confs, dp_Rs, dp_ts, p: EmParams):
    """Sample the prior depth and confidence maps at the projections of the
    current depth (``em.py:301``). Returns (target, weight, dp_Rs, dp_ts)."""
    _, px, py, inb = prior_terms(depth, priors, dp_Rs, dp_ts, p)
    target = _sample_stack(priors, px, py)
    cw = _sample_stack(dp_pconfs * dp_confs, px, py)
    weight = torch.where(inb, cw * _slot_weights(priors.shape[0], p, depth.device), 0.0)
    target = torch.where(inb, target, 0.0)
    return target, weight, dp_Rs, dp_ts


def _slot_weights(D: int, p: EmParams, device):
    """(D, 1, 1) per-prior weights: disp_delta for the disparity prior in
    slot 0 (when disp_delta > 0), delta for the others."""
    slot0 = p.disp_delta > 0
    with device_sync("em.upload", device):
        w = torch.tensor(
            [p.disp_delta if (slot0 and d == 0) else p.delta for d in range(D)],
            dtype=torch.float32, device=device,
        )
    return w[:, None, None]


def update_rigidness(depth, flows, Rs, ts, active_n: int, p: EmParams):
    """Per-frame rigidness maps (``em.py:325``): one chain trace
    (``ops/chain_trace.py``), without the track planes."""
    return chain_trace(depth, flows, Rs, ts, active_n, p, tracks=False)[0]


def update_rigidness_and_tracks(depth, flows, Rs, ts, active_n: int, p: EmParams):
    """Rigidness refresh plus the 'anchored' track planes from one chain
    trace (``em.py:332``): (rigidness, (px1, py1, obx, oby), inb)."""
    rigidness, inb, track = chain_trace(depth, flows, Rs, ts, active_n, p)
    return rigidness, track, inb


def update_prior_confs(depth, priors, dp_confs, dp_Rs, dp_ts, p: EmParams):
    """Depth-prior confidence maps (``em.py:350``); the previous confidence
    is kept where the sampled prior depth is not positive."""
    oz, px, py, inb = prior_terms(depth, priors, dp_Rs, dp_ts, p)
    target = _sample_stack(priors, px, py)
    r = fisk.depth_rigidness(
        oz, torch.clamp_min(target, 1e-12), p.basefocal, p.omega, p.abs_resize_factor
    )
    new = torch.where(target > 0, r, dp_confs)
    return torch.where(inb, new, 0.0)


def compute_cost_map(
    depth, flows, rigidness, Rs, ts, priors, dp_pconfs, dp_confs, dp_Rs, dp_ts,
    active_n: int, p: EmParams,
):
    """Per-pixel Fisk NLL of one candidate depth map with the chain traced
    for this candidate (``em.py:364``, optimize_depth.cu:140-198): the
    'projected' cost. The rigidness and prior-confidence maps weigh each
    term at the home pixel; the disparity prior in slot 0 takes disp_delta.
    flows or priors may be None (or empty). Pixels whose weights sum to 0
    get +inf."""
    h, w = depth.shape
    cost = torch.zeros((h, w), dtype=torch.float32, device=depth.device)
    wsum = torch.zeros((h, w), dtype=torch.float32, device=depth.device)

    if flows is not None and flows.shape[0] > 0:
        rx, ry, obx, oby, inb, _, _ = chain_flow_terms(depth, flows, Rs, ts, active_n, p)
        r = fisk.rigidness_xy(rx, ry, obx, oby, p.lam, p.abs_resize_factor)
        c = -rigidness * torch.log(torch.clamp_min(r, 1e-30))
        cost = cost + torch.where(inb, c, 0.0).sum(dim=0)
        wsum = wsum + torch.where(inb, rigidness, 0.0).sum(dim=0)

    if priors is not None and priors.shape[0] > 0:
        oz, px, py, inb = prior_terms(depth, priors, dp_Rs, dp_ts, p)
        target = _sample_stack(priors, px, py)
        pconf = _sample_stack(dp_pconfs, px, py)
        conf = _sample_stack(dp_confs, px, py)
        weight = pconf * conf * _slot_weights(priors.shape[0], p, depth.device)
        r = fisk.depth_rigidness(
            oz, torch.clamp_min(target, 1e-12), p.basefocal, p.omega, p.abs_resize_factor
        )
        use = inb & (target > 0)
        cost = cost + torch.where(use, -weight * torch.log(torch.clamp_min(r, 1e-30)), 0.0).sum(dim=0)
        wsum = wsum + torch.where(use, weight, 0.0).sum(dim=0)

    return normalize_cost(cost, wsum)


# --------------------------------------------------------------------------
# Depth update (PatchMatch proposals)
# --------------------------------------------------------------------------


def draw_depth_uniforms(gen: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """The (n, h, w) proposal uniforms of one depth round."""
    return torch.rand((n, h, w), generator=gen, device=device, dtype=torch.float32)


def _shift_depth(depth, dy: int, dx: int):
    """Each pixel proposes the depth of its (dy, dx)-offset neighbour;
    out-of-range pixels propose their own depth (``em.py:424``)."""
    h, w = depth.shape
    shifted = depth.clone()
    valid = torch.zeros((h, w), dtype=torch.bool, device=depth.device)
    y0, y1 = max(0, -dy), min(h, h - dy)
    x0, x1 = max(0, -dx), min(w, w - dx)
    if y0 < y1 and x0 < x1:
        shifted[y0:y1, x0:x1] = depth[y0 + dy:y1 + dy, x0 + dx:x1 + dx]
        valid[y0:y1, x0:x1] = True
    return shifted, valid


_GLOBAL_DIRS = (
    (0, -1, True, False),  # L2R: visited x=1,1+step..., candidate from x-1
    (1, 0, False, True),  # B2T
    (0, 1, True, True),  # R2L
    (-1, 0, False, False),  # T2B
)
_LOCAL_DIRS = ((0, -1), (1, 0), (0, 1), (-1, 0))


def _global_mask(h, w, along_x, start_hi, step, device):
    n = w if along_x else h
    idx = torch.arange(n, device=device)
    if start_hi:
        visited = ((n - 2 - idx) % step == 0) & (idx <= n - 2)
    else:
        visited = ((idx - 1) % step == 0) & (idx >= 1)
    return visited[None, :] if along_x else visited[:, None]


def _jump_offsets(width):
    offsets, o = [], 1
    while o < width:
        offsets.append(o)
        o *= 2
    return offsets


def optimize_depth(
    depth, cost, cost_fn, u, *, global_prop_step: int = 8, local_prop_width: int = 32,
    range_factor: float = 1.0, local_prop_mode: str = "jump",
):
    """One depth-update round, accepting one proposal map at a time
    (``em.py:441``). ``cost_fn(depth) -> cost map``; ``u`` holds the
    (n_rand, h, w) proposal uniforms. Local propagation runs as
    jump-flooding sweeps ('jump') or as the reference's serial chains
    within chunks of ``local_prop_width`` ('exact': 4 x (width - 1) masked
    accepts, each scoring a whole map). Returns (depth, cost)."""
    if local_prop_mode not in ("jump", "exact"):
        raise ValueError(f"unknown local_prop_mode {local_prop_mode}")
    h, w = depth.shape

    def accept(depth, cost, cand, mask):
        cand_cost = cost_fn(cand)
        better = mask & (cand_cost < cost)
        return torch.where(better, cand, depth), torch.where(better, cand_cost, cost)

    everywhere = torch.ones((h, w), dtype=torch.bool, device=depth.device)
    for i in range(u.shape[0]):
        cand = 1.0 / (range_factor * u[i] + 1.0 / MAXIMUM_DEPTH)
        depth, cost = accept(depth, cost, cand, everywhere)

    if global_prop_step > 0:
        for dy, dx, along_x, start_hi in _GLOBAL_DIRS:
            cand, valid = _shift_depth(depth, dy, dx)
            mask = _global_mask(h, w, along_x, start_hi, global_prop_step, depth.device)
            depth, cost = accept(depth, cost, cand, valid & mask)

    if local_prop_width > 0 and local_prop_mode == "jump":
        offsets = _jump_offsets(local_prop_width)
        for sy, sx in _LOCAL_DIRS:
            for o in offsets:
                cand, valid = _shift_depth(depth, sy * o, sx * o)
                depth, cost = accept(depth, cost, cand, valid)
    elif local_prop_width > 0:
        for dy, dx in _LOCAL_DIRS:
            for k in range(1, local_prop_width):
                cand, valid = _shift_depth(depth, dy, dx)
                mask = _chain_mask(h, w, dy, dx, k, local_prop_width, depth.device)
                depth, cost = accept(depth, cost, cand, valid & mask)
    return depth, cost


def _chain_mask(h, w, dy, dx, k, width, device):
    """Step k of the exact chains (``em.py:537-558``): the pixels at chunk
    position k (k-th from the far end for the R2L and B2T chains) take
    their (dy, dx) neighbour's depth."""
    n = w if dx != 0 else h
    idx = torch.arange(n, device=device)
    km = k % width
    if dx == -1 or dy == -1:  # L2R, T2B
        sel = ((idx % width) == km) & (idx >= 1)
    else:  # R2L, B2T
        sel = ((idx % width) == (width - 1 - km) % width) & (idx <= n - 2)
    return sel[None, :] if dx != 0 else sel[:, None]


def optimize_depth_batched(
    depth, cost, accept_fn, u, *, global_prop_step: int = 8,
    local_prop_width: int = 32, range_factor: float = 1.0,
):
    """Batched-proposal depth update (``em.py:573``): each proposal family
    is scored and accepted by per-pixel argmin in ONE
    ``accept_fn(depth, cost, cands (K, h, w), masks (K, h, w) bool or None)
    -> (depth, cost)`` call (``ops/cost.py:cost_map_accept``; masks None
    keeps every candidate). ``u``: (n_rand, h, w) uniforms. ``accept_fn``
    may update depth and cost in place: the round works on copies, so the
    caller's tensors are left as they were."""
    h, w = depth.shape
    depth, cost = depth.clone(), cost.clone()

    if u.shape[0] > 0:
        cands = 1.0 / (range_factor * u + 1.0 / MAXIMUM_DEPTH)
        depth, cost = accept_fn(depth, cost, cands, None)

    if global_prop_step > 0:
        cands, masks = [], []
        for dy, dx, along_x, start_hi in _GLOBAL_DIRS:
            cand, valid = _shift_depth(depth, dy, dx)
            cands.append(cand)
            masks.append(valid & _global_mask(h, w, along_x, start_hi, global_prop_step, depth.device))
        depth, cost = accept_fn(depth, cost, torch.stack(cands), torch.stack(masks))

    for o in _jump_offsets(local_prop_width):
        cands, masks = [], []
        for sy, sx in _LOCAL_DIRS:
            cand, valid = _shift_depth(depth, sy * o, sx * o)
            cands.append(cand)
            masks.append(valid)
        depth, cost = accept_fn(depth, cost, torch.stack(cands), torch.stack(masks))
    return depth, cost
