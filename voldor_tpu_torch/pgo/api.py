"""``pgo()`` — the pyvoldor-compatible pose-graph entry point (port of
``voldor_tpu/pgo/api.py``): poses (N, 7) [rvec, tvec, log s], an edge list
with 7x7 covariances, optimised (N, 7) back; plus a ``device`` keyword
(default: the CUDA device, and an error without one)."""

from __future__ import annotations

import numpy as np

from voldor_tpu_torch.ops import lie
from voldor_tpu_torch.pgo.reduce import chain_reduce, redistribute_chain
from voldor_tpu_torch.pgo.solver import build_problem, pgo_solve_dense_jit, pgo_solve_jit
from voldor_tpu_torch.utils import profiling
from voldor_tpu_torch.vo.engine import resolve_device

# The dense Cholesky LM serves graphs up to this many poses, matrix-free CG
# larger ones. It is the JAX package's choice (api.py:85): dense while its
# pose count, padded to a power-of-two bucket of at least 64, has at most
# 8192 tangent dims, i.e. up to 1024 poses.
DENSE_MAX_POSES = 1024


def pgo(
    poses: np.ndarray,
    edges_idx: np.ndarray,
    edges_pose: np.ndarray,
    edges_covar: np.ndarray | None = None,
    poses_idx: np.ndarray | None = None,
    optimize_7dof: bool = False,
    debug: bool = False,
    reduce_threshold_dofs: int = 8192,
    device=None,
) -> np.ndarray:
    """reduce_threshold_dofs: tangent-dim count above which degree-2 chain
    vertices are marginalised before the solve (pgo/reduce.py; tests pass
    0 to exercise it on small graphs). Where a trace record is open on the
    thread (``utils/profiling.py``), ``pgo_iters`` counts the LM
    iterations."""
    dev = resolve_device(device)
    poses = np.ascontiguousarray(poses, np.float32)
    edges_idx = np.ascontiguousarray(edges_idx, np.int32)
    edges_pose = np.ascontiguousarray(edges_pose, np.float32)
    if edges_covar is None:
        edges_covar = np.tile(np.eye(7, dtype=np.float32), (edges_pose.shape[0], 1, 1))

    # Large graphs: marginalise the degree-2 chain vertices exactly, solve
    # the reduced graph, then redistribute the corrections along each chain
    n_in = poses.shape[0]
    if poses_idx is None and n_in * 7 > reduce_threshold_dofs:
        kept_ids, red_idx, red_pose, red_covar, segments = chain_reduce(
            n_in, edges_idx, edges_pose, edges_covar)
        if len(kept_ids) < n_in:
            remap = np.full(n_in, -1, np.int64)
            remap[kept_ids] = np.arange(len(kept_ids))
            red_idx_c = remap[red_idx.astype(np.int64)].astype(np.int32)
            if debug:
                print(f"PGO chain reduction: {n_in} -> {len(kept_ids)} poses, "
                      f"{edges_idx.shape[0]} -> {red_idx.shape[0]} edges")
            solved_kept = pgo(poses[kept_ids], red_idx_c, red_pose, red_covar,
                              optimize_7dof=optimize_7dof, debug=debug, device=dev)
            kept_rows = {int(kid): i for i, kid in enumerate(kept_ids)}
            return redistribute_chain(poses, solved_kept, kept_rows, segments)

    prob, ids, info = build_problem(poses, poses_idx, edges_idx, edges_pose, edges_covar,
                                    optimize_7dof, dev)
    if debug:
        print(f"Number of poses: {info['n_poses']}")
        print(f"Number of constraints: {info['n_edges']}")
    if info["n_edges"] == 0:
        return poses.copy()

    solve = pgo_solve_dense_jit if info["n_poses"] <= DENSE_MAX_POSES else pgo_solve_jit
    solved, cost, iters = solve(prob)
    if debug:
        print(f"PGO cost {float(cost):.6f} after {int(iters)} LM iterations")

    out = np.zeros((info["n_poses"], 7), np.float32)
    out[:, :3] = lie.quat_to_rvec(solved.q).cpu().numpy()
    out[:, 3:6] = solved.p.cpu().numpy()
    out[:, 6] = solved.s.cpu().numpy()
    if profiling.recording():  # the solve has ended: this read waits for nothing
        profiling.count("pgo_iters", int(iters))
    return out
