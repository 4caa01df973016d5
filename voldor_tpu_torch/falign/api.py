"""``falign()`` and ``falign_pairs()`` — the pyvoldor-compatible frame-alignment
entry points (port of ``voldor_tpu/falign/api.py``): same signatures, shapes
and return dicts, plus a ``device`` keyword (default: the CUDA device, and
an error without one; CPU callers pass ``device="cpu"``).

The JAX package pads the pair axis of ``falign_pairs`` to {4, 16} lane
buckets and chunk dispatches to bucket sizes, to bound its compiled
executables; the port runs the lanes it is given.
"""

from __future__ import annotations

import numpy as np
import torch

from voldor_tpu_torch.falign.residual import precompute_maps
from voldor_tpu_torch.falign.solver import (LaneProblem, align_scores, pair_covariances,
                                            solve_lanes)
from voldor_tpu_torch.utils import profiling
from voldor_tpu_torch.vo.engine import resolve_device

# iterations between two reads of the lanes' done flags: the JAX package's
# chunks (api.py:174); the single-lane falign() uses the fine one
CHUNK_COARSE = 16
CHUNK_FINE = 8
MAX_ITERS = 100  # falign()'s LM budget (lm_solve's default, solver.py:281)


def _tensor(a, dev, shape=None):
    if a is None:
        return None
    a = np.ascontiguousarray(a, np.float32)
    if shape is not None:
        a = a.reshape(shape)
    return torch.as_tensor(a, device=dev)


def _problem(maps, pairs, n_frames, fx, fy, cx, cy, vbf, crw, use_photo, dim_mask, gauge_U, dev):
    def s(v):
        return torch.tensor(float(v), dtype=torch.float32, device=dev)

    scalars = tuple(float(np.float32(v)) for v in (fx, fy, cx, cy, vbf, crw))

    pairs = np.asarray(pairs, np.int64)
    eye = np.eye(n_frames, dtype=np.float32)
    return LaneProblem(
        maps=maps, pairs=torch.as_tensor(pairs, device=dev),
        oh_r=torch.as_tensor(eye[pairs[:, 0]], device=dev),
        oh_t=torch.as_tensor(eye[pairs[:, 1]], device=dev), n_frames=n_frames,
        intr=(s(fx), s(fy), s(cx), s(cy)), vbf=s(vbf), crw=s(crw), scalars=scalars,
        use_photo=use_photo,
        dim_mask=torch.as_tensor(dim_mask, device=dev), gauge_U=torch.as_tensor(gauge_U, device=dev),
    )


def _dim_mask(n, optimize_7dof, use_photo):
    """Active parameter dims per frame: pose always; depth scale if 7-dof;
    colour if photometric."""
    dim_mask = np.zeros((n, 9), np.float32)
    dim_mask[:, :6] = 1.0
    if optimize_7dof:
        dim_mask[:, 6] = 1.0
    if use_photo:
        dim_mask[:, 7:9] = 1.0
    return dim_mask


def falign(
    depths: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    weights: np.ndarray | None = None,
    images: np.ndarray | None = None,
    poses_init: np.ndarray | None = None,
    connectivity: np.ndarray | None = None,
    vbf: float = 1000.0,
    crw: float = 10.0,
    optimize_7dof: bool = False,
    graduated_optmize: bool = False,  # accepted for compatibility; unused upstream too
    stride: int = 4,
    consistency_residual_bound: float = 1.0,
    debug: bool = False,
    device=None,
) -> dict:
    """Dense pairwise alignment of N keyframes (``api.py:18``).

    depths: (N, h, w); weights/images: (N, h, w); poses_init: (N, 6)
    cam->world [rvec, tvec]; connectivity: flat (ref, tar) pairs terminated
    by -1, default fully connected. Returns {'poses_ret' (N, 6),
    'poses_covar' (N, 7, 7) if optimize_7dof else (N, 6, 6),
    'scaling_factor' (N,), 'visibility_mat' (N, N), 'consistency_mat'
    (N, N)} with NaN matrix entries where unconnected."""
    dev = resolve_device(device)
    depths = np.ascontiguousarray(depths, np.float32)
    N, h, w = depths.shape
    use_photo = images is not None and crw > 0

    if connectivity is not None:
        flat = list(np.asarray(connectivity).ravel())
        pairs = []
        i = 0
        while i < len(flat) and flat[i] != -1:
            pairs.append((int(flat[i]), int(flat[i + 1])))
            i += 2
    else:
        pairs = [(r, t) for r in range(N) for t in range(N) if r != t]

    params0 = np.zeros((1, N, 9), np.float32)
    if poses_init is not None:
        params0[0, :, :6] = np.asarray(poses_init, np.float32)

    # per-connected-component scale-gauge rows (7-dof only, solver.py:306):
    # union-find over the pair graph, one indicator row per component
    gauge_U = np.zeros((0, N * 9), np.float32)
    if optimize_7dof:
        parent = list(range(N))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for r, t in pairs:
            ra, rb = find(r), find(t)
            if ra != rb:
                parent[ra] = rb
        comp_of = {}
        rows = []
        for i in range(N):
            if not any(i in p for p in pairs):
                continue  # isolated frame: no residuals, no gauge
            r = find(i)
            if r not in comp_of:
                comp_of[r] = len(rows)
                rows.append(np.zeros(N * 9, np.float32))
            rows[comp_of[r]][i * 9 + 6] = 1.0
        if rows:
            gauge_U = np.stack(rows)

    maps = precompute_maps(_tensor(depths, dev), _tensor(weights, dev), _tensor(images, dev),
                           fx, fy, cx, cy)
    prob = _problem(maps, pairs, N, fx, fy, cx, cy, vbf, crw, use_photo,
                    _dim_mask(N, optimize_7dof, use_photo), gauge_U, dev)
    lanes = torch.zeros(1, dtype=torch.int64, device=dev)
    params_t, _, _ = solve_lanes(prob, torch.as_tensor(params0, device=dev),
                                 [(int(stride), MAX_ITERS, CHUNK_FINE)])
    covars_t, _ = pair_covariances(prob, params_t, lanes, int(stride))
    vis_t, cons_t = align_scores(prob, params_t, lanes, float(consistency_residual_bound),
                                 int(stride))
    params = params_t[0].cpu().numpy()
    covars9 = covars_t[0].cpu().numpy()
    vis, cons = vis_t[0].cpu().numpy(), cons_t[0].cpu().numpy()

    d = 7 if optimize_7dof else 6
    poses_covar = np.zeros((N, d, d), np.float32)
    poses_covar[:, :6, :6] = covars9[:, :6, :6]
    if optimize_7dof:
        # only the (pose, pose) and (scale, scale) blocks (align_frame.cpp:174-195)
        poses_covar[:, 6, 6] = covars9[:, 6, 6]
    visibility_mat = np.full((N, N), np.nan, np.float32)
    consistency_mat = np.full((N, N), np.nan, np.float32)
    for k, (r, t) in enumerate(pairs):
        visibility_mat[r, t] = vis[k]
        consistency_mat[r, t] = cons[k]

    scaling = np.exp(params[:, 6]) if optimize_7dof else np.ones(N, np.float32)
    return {
        "poses_ret": params[:, :6].astype(np.float32),
        "poses_covar": poses_covar,
        "scaling_factor": scaling.astype(np.float32),
        "visibility_mat": visibility_mat,
        "consistency_mat": consistency_mat,
    }


def falign_pairs(
    depths: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    weights: np.ndarray | None = None,
    images: np.ndarray | None = None,
    poses_init: np.ndarray | None = None,
    vbf: float = 1000.0,
    crw: float = 10.0,
    optimize_7dof: bool = False,
    stride: int = 4,
    consistency_residual_bound: float = 1.0,
    coarse_stride: int = 0,
    fine_iters: int = 100,
    coarse_iters: int = 100,
    device=None,
) -> list[dict]:
    """P independent two-frame alignment problems in one batch
    (``api.py:272``): the pairs ride the lane axis of the 2-frame LM.

    depths: (P, 2, h, w); weights/images optional, same shape; poses_init:
    (P, 2, 6). Returns a list of P dicts with falign()'s keys on each
    2-frame problem plus ``iters`` (fine-grid LM iterations) and
    ``iters_coarse`` (coarse-grid iterations, 0 without coarse-to-fine).
    coarse_stride > stride runs up to coarse_iters iterations on the
    coarse grid first, then at most fine_iters at stride; scores and
    covariances come from the fine stride.

    Traced (``utils/profiling.py``) where a record is open: the maps'
    upload and the problem, and each phase's start, in ``falign.setup``;
    each LM chunk in ``falign.lm``; the covariances, scores and the reads
    of the results in ``falign.finish``; ``falign_pairs`` counts the
    pairs."""
    dev = resolve_device(device)
    depths = np.ascontiguousarray(depths, np.float32)
    P, two, h, w = depths.shape
    assert two == 2
    use_photo = images is not None and crw > 0
    shape = (P * 2, h, w)
    profiling.count("falign_pairs", P)
    with profiling.span("falign.setup"):
        maps = precompute_maps(_tensor(depths, dev, shape), _tensor(weights, dev, shape),
                               _tensor(images, dev, shape), fx, fy, cx, cy)

        params0 = np.zeros((P, 2, 9), np.float32)
        if poses_init is not None:
            params0[:, :, :6] = np.asarray(poses_init, np.float32)
        gauge_U = np.zeros((1 if optimize_7dof else 0, 18), np.float32)
        if optimize_7dof:
            gauge_U[0, 6] = gauge_U[0, 15] = 1.0
        prob = _problem(maps, ((0, 1), (1, 0)), 2, fx, fy, cx, cy, vbf, crw, use_photo,
                        _dim_mask(2, optimize_7dof, use_photo), gauge_U, dev)

    phases = []
    c2f = coarse_stride > stride and coarse_iters > 0
    if c2f:
        phases.append((int(coarse_stride), int(coarse_iters), CHUNK_COARSE))
    phases.append((int(stride), int(fine_iters), CHUNK_FINE))
    params_t, _, iters = solve_lanes(prob, torch.as_tensor(params0, device=dev), phases)
    with profiling.span("falign.finish"):
        lanes = torch.arange(P, device=dev)
        covars_t, _ = pair_covariances(prob, params_t, lanes, int(stride))
        vis_t, cons_t = align_scores(prob, params_t, lanes, float(consistency_residual_bound),
                                     int(stride))
        params_b, covars_b, vis_b, cons_b = (
            t.cpu().numpy() for t in (params_t, covars_t, vis_t, cons_t))
    iters_fine = iters[-1]
    iters_coarse = iters[0] if c2f else np.zeros(P, np.int32)

    d = 7 if optimize_7dof else 6
    out = []
    for i in range(P):
        poses_covar = np.zeros((2, d, d), np.float32)
        poses_covar[:, :6, :6] = covars_b[i, :, :6, :6]
        if optimize_7dof:
            poses_covar[:, 6, 6] = covars_b[i, :, 6, 6]
        vm = np.full((2, 2), np.nan, np.float32)
        cm = np.full((2, 2), np.nan, np.float32)
        vm[0, 1], vm[1, 0] = vis_b[i, 0], vis_b[i, 1]
        cm[0, 1], cm[1, 0] = cons_b[i, 0], cons_b[i, 1]
        scaling = (np.exp(params_b[i, :, 6]) if optimize_7dof else np.ones(2, np.float32))
        out.append({
            "poses_ret": params_b[i, :, :6],
            "poses_covar": poses_covar,
            "scaling_factor": scaling,
            "visibility_mat": vm,
            "consistency_mat": cm,
            "iters": int(iters_fine[i]),
            "iters_coarse": int(iters_coarse[i]),
        })
    return out
