"""g2o-format pose-graph IO (VERTEX_SE3:QUAT / EDGE_SE3:QUAT); a copy of
``voldor_tpu/pgo/g2o.py`` (pure numpy), so the port imports nothing of the
JAX package.

Equivalent of pose-graph/read_g2o.h + the debug main (pose-graph/
main.cpp:4-36); lets the solver run on standard pose-graph benchmark
files (sphere2500, torus, ...) as a correctness oracle.
"""

from __future__ import annotations

import numpy as np


def _quat_to_rvec64(qw, qx, qy, qz):
    """Host float64 quaternion -> rotation vector (file IO stays at full
    precision; the device lie ops would truncate to f32 with a warning)."""
    v = np.asarray([qx, qy, qz], np.float64)
    n = float(np.linalg.norm(v))
    w = float(qw)
    theta = 2.0 * np.arctan2(n, w)
    if theta > np.pi:  # shorter arc
        theta -= 2.0 * np.pi
    if n < 1e-12:
        return np.zeros(3, np.float64)
    return v / n * theta


def _rvec_to_quat64(rvec):
    rvec = np.asarray(rvec, np.float64)
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.array([1.0, 0.0, 0.0, 0.0])
    ax = rvec / theta
    return np.concatenate([[np.cos(theta / 2)], np.sin(theta / 2) * ax])


def read_g2o(path: str):
    """Returns (ids (N,), poses7 (N, 7) [rvec, t, s=0], edges_idx (M, 2),
    edges_pose7 (M, 7), edges_covar (M, 7, 7))."""
    ids = []
    poses = []
    e_idx = []
    e_pose = []
    e_cov = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "VERTEX_SE3:QUAT":
                vid = int(tok[1])
                x, y, z, qx, qy, qz, qw = map(float, tok[2:9])
                rvec = _quat_to_rvec64(qw, qx, qy, qz)
                ids.append(vid)
                poses.append([*rvec, x, y, z, 0.0])
            elif tok[0] == "EDGE_SE3:QUAT":
                i, j = int(tok[1]), int(tok[2])
                x, y, z, qx, qy, qz, qw = map(float, tok[3:10])
                upper = list(map(float, tok[10:31]))
                info6 = np.zeros((6, 6))
                k = 0
                for a in range(6):
                    for b in range(a, 6):
                        info6[a, b] = info6[b, a] = upper[k]
                        k += 1
                rvec = _quat_to_rvec64(qw, qx, qy, qz)
                # g2o information is in (t, q) order; convert to a 7x7
                # covariance in our (rvec, t, s) wire order so build_problem's
                # standard transform (types.h:103-125) round-trips it.
                cov6 = np.linalg.inv(info6)
                theta = np.linalg.norm(rvec)
                kq = np.sin(theta / 2) / theta if theta > 0 else 0.5
                cov7 = np.zeros((7, 7))
                # (t, q) -> (rvec, t): rvec = q / kq scaling on rotation dims
                cov7[3:6, 3:6] = cov6[:3, :3]
                cov7[:3, :3] = cov6[3:6, 3:6] / (kq * kq)
                cov7[:3, 3:6] = cov6[3:6, :3] / kq
                cov7[3:6, :3] = cov6[:3, 3:6] / kq
                cov7[6, 6] = 1.0  # scale unconstrained in SE(3) files
                # g2o's Z_ij = X_i^-1 X_j maps j-frame points into i's frame;
                # our wire format wants T_{end<-begin}, so store the edge as
                # (begin=j, end=i) and the measurement fits unchanged.
                e_idx.append([j, i])
                e_pose.append([*rvec, x, y, z, 0.0])
                e_cov.append(cov7)
    order = np.argsort(ids)
    return (
        np.asarray(ids, np.int64)[order],
        np.asarray(poses, np.float32)[order],
        np.asarray(e_idx, np.int32),
        np.asarray(e_pose, np.float32),
        np.asarray(e_cov, np.float32),
    )


def write_g2o(path: str, ids, poses7):
    """Write VERTEX_SE3:QUAT lines (id x y z qx qy qz qw)."""
    q = np.stack([_rvec_to_quat64(r) for r in np.asarray(poses7)[:, :3]])
    with open(path, "w") as f:
        for i, pid in enumerate(ids):
            x, y, z = poses7[i, 3:6]
            f.write(
                f"VERTEX_SE3:QUAT {int(pid)} {x} {y} {z} "
                f"{q[i,1]} {q[i,2]} {q[i,3]} {q[i,0]}\n"
            )
