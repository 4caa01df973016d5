"""Trajectory evaluation: ATE-RMSE after a Umeyama (Sim3) alignment, the
KITTI odometry relative errors and the KITTI pose-file reader (numpy;
counterpart of ``voldor_tpu/utils/evaluation.py``)."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform with dst ~ s * R @ src + t.
    src, dst: (N, 3). Returns (s, R, t)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = 1.0
    if with_scale:
        var_s = (xs * xs).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    return s, R, mu_d - s * R @ mu_s


def ate_rmse(est_T: np.ndarray, gt_T: np.ndarray, with_scale: bool = True) -> float:
    """ATE RMSE of (N, 4, 4) cam->world poses after alignment."""
    p_est = est_T[:, :3, 3]
    p_gt = gt_T[:, :3, 3]
    s, R, t = umeyama_alignment(p_est, p_gt, with_scale)
    err = (s * (R @ p_est.T)).T + t - p_gt
    return float(np.sqrt((err * err).sum(axis=1).mean()))


def _trajectory_distances(T: np.ndarray) -> np.ndarray:
    """Distance travelled up to each of the (N, 4, 4) poses."""
    d = np.zeros(T.shape[0])
    steps = np.linalg.norm(np.diff(T[:, :3, 3], axis=0), axis=1)
    d[1:] = np.cumsum(steps)
    return d


def kitti_rel_errors(est_T: np.ndarray, gt_T: np.ndarray,
                     lengths=(100, 200, 300, 400, 500, 600, 700, 800), step: int = 10):
    """KITTI odometry metric: the average relative translation error (%)
    and rotation error (deg/m) over sub-sequences of the standard lengths,
    starting every ``step`` frames.

    Returns (t_rel_percent, r_rel_deg_per_m); NaNs if the trajectory is
    shorter than the smallest length."""
    dist = _trajectory_distances(gt_T)
    t_errs, r_errs = [], []
    for first in range(0, est_T.shape[0], step):
        for length in lengths:
            last = np.searchsorted(dist, dist[first] + length)
            if last >= est_T.shape[0]:
                continue
            gt_rel = np.linalg.inv(gt_T[first]) @ gt_T[last]
            est_rel = np.linalg.inv(est_T[first]) @ est_T[last]
            err = np.linalg.inv(gt_rel) @ est_rel
            t_err = np.linalg.norm(err[:3, 3])
            ang = np.degrees(np.arccos(np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)))
            t_errs.append(t_err / length * 100.0)
            r_errs.append(ang / length)
    if not t_errs:
        return float("nan"), float("nan")
    return float(np.mean(t_errs)), float(np.mean(r_errs))


def load_kitti_poses(path: str) -> np.ndarray:
    """(N, 4, 4) poses from a KITTI pose file (a 3 x 4 matrix per line)."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    T = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    T[:, :3, :4] = rows
    return T
