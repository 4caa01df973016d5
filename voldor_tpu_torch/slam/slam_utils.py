"""Host-side SLAM geometry helpers (numpy; a copy of
``voldor_tpu/slam/slam_utils.py``).

Parity targets: slam_py/slam_utils.py (eval_covisibility, geometry_check,
pose conversions). Pose conversions run in numpy via closed-form Rodrigues
so the SLAM bookkeeping never waits on a device dispatch.
"""

from __future__ import annotations

import numpy as np


def rvec_to_R(rvec: np.ndarray) -> np.ndarray:
    """Rodrigues, numpy (matches cv2.Rodrigues / ops.lie.so3_exp)."""
    rvec = np.asarray(rvec, np.float64)
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        K = _hat(rvec)
        return np.eye(3) + K
    k = rvec / theta
    K = _hat(k)
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def R_to_rvec(R: np.ndarray) -> np.ndarray:
    """Inverse Rodrigues via quaternion extraction (robust near pi)."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    q = np.empty(4)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q[:] = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q[:] = [(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s]
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q[:] = [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s, (R[1, 2] + R[2, 1]) / s]
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q[:] = [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, 0.25 * s]
    q /= np.linalg.norm(q)
    w, xyz = q[0], q[1:]
    sin_half = np.linalg.norm(xyz)
    if sin_half < 1e-12:
        return xyz * 2.0
    theta = 2.0 * np.arctan2(sin_half, w)
    return xyz / sin_half * theta


def _hat(v):
    return np.asarray(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], np.float64
    )


def T44_to_T6(poses: np.ndarray) -> np.ndarray:
    """(4,4)->(6,) or (N,4,4)->(N,6) (slam_utils.py:59-75)."""
    poses = np.asarray(poses)
    if poses.ndim == 2:
        out = np.zeros(6, poses.dtype)
        out[:3] = R_to_rvec(poses[:3, :3])
        out[3:] = poses[:3, 3]
        return out
    out = np.zeros((poses.shape[0], 6), poses.dtype)
    for i in range(poses.shape[0]):
        out[i, :3] = R_to_rvec(poses[i, :3, :3])
        out[i, 3:] = poses[i, :3, 3]
    return out


def T6_to_T44(poses: np.ndarray) -> np.ndarray:
    """(6,)->(4,4) or (N,6)->(N,4,4) (slam_utils.py:77-95)."""
    poses = np.asarray(poses)
    if poses.ndim == 1:
        T = np.zeros((4, 4), poses.dtype)
        T[:3, :3] = rvec_to_R(poses[:3])
        T[:3, 3] = poses[3:6]
        T[3, 3] = 1
        return T
    out = np.zeros((poses.shape[0], 4, 4), poses.dtype)
    for i in range(poses.shape[0]):
        out[i, :3, :3] = rvec_to_R(poses[i, :3])
        out[i, :3, 3] = poses[i, 3:6]
        out[i, 3, 3] = 1
    return out


def polish_T44(pose: np.ndarray) -> None:
    """In-place SVD re-orthonormalization (slam_utils.py:55-57)."""
    u, _, vt = np.linalg.svd(pose[:3, :3])
    pose[:3, :3] = u @ vt


def geometry_check(kp1, des1, kp2, des2) -> float:
    """ORB BF-Hamming match + fundamental-matrix RANSAC inlier rate
    (slam_utils.py:4-16). Requires cv2. Where OpenCV's estimator raises
    (OpenCV 4.13.0 raised (-215) ``_rowRange`` on one keyframe pair of
    ~200 keypoints each), the pair has no verified geometry: 0.0, as when
    no mask comes back. The JAX package lets the error kill the VO thread."""
    import cv2

    bf = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)
    matches = bf.knnMatch(des1, des2, k=1)
    pts1, pts2 = [], []
    for m in matches:
        if len(m) > 0:
            pts1.append(kp1[m[0].queryIdx].pt)
            pts2.append(kp2[m[0].trainIdx].pt)
    if len(pts1) < 8:
        return 0.0
    pts1 = np.asarray(pts1, np.float32)
    pts2 = np.asarray(pts2, np.float32)
    try:
        F, mask = cv2.findFundamentalMat(pts1, pts2, cv2.FM_RANSAC)
    except cv2.error:
        return 0.0
    if mask is None:
        return 0.0
    return (2.0 * float(np.sum(mask))) / (len(kp1) + len(kp2))


class _CovisCache:
    shape = None
    stride = None
    K = None
    coords_3d = None


def eval_covisibility(depth, Tc1c2, K, mask=None, stride=4) -> float:
    """Covisibility score (slam_utils.py:18-53): harmonic mean of the
    in-bounds fraction and the histogram-coverage fraction of a strided
    depth grid reprojected through Tc1c2."""
    depth = np.asarray(depth)
    h, w = depth.shape
    c = _CovisCache
    if c.shape != depth.shape or c.stride != stride or not np.array_equal(c.K, K):
        c.shape = depth.shape
        c.stride = stride
        c.K = np.asarray(K).copy()
        Iy, Ix = np.mgrid[0:h:stride, 0:w:stride]
        coords = np.stack([Ix, Iy, np.ones_like(Ix)], axis=2).astype(np.float32)
        coords = coords.reshape(-1, 3)
        c.coords_3d = (np.linalg.inv(K) @ coords.T).T

    pts = c.coords_3d * depth[::stride, ::stride].reshape(-1, 1)
    if mask is not None:
        pts = pts[np.asarray(mask)[::stride, ::stride].reshape(-1)]
    pts = (np.asarray(Tc1c2)[:3, :3] @ pts.T).T + np.asarray(Tc1c2)[:3, 3]

    proj = (np.asarray(K) @ pts.T).T
    proj = proj[proj[:, 2] > 0]
    proj = proj[:, :2] / proj[:, 2:3]

    visible = (
        (proj[:, 0] > 0) & (proj[:, 0] < w) & (proj[:, 1] > 0) & (proj[:, 1] < h)
    )
    visibility = np.sum(visible) / ((w // stride) * (h // stride))
    coverage, _, _ = np.histogram2d(
        proj[:, 0], proj[:, 1], bins=(w // (2 * stride), h // (2 * stride)),
        range=((0, w), (0, h)),
    )
    coverage = np.sum(coverage > 0) / ((w // (2 * stride)) * (h // (2 * stride)))
    return 2 * (visibility * coverage) / max(visibility + coverage, 1)
