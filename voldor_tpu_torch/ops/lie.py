"""Batched SO(3) / SE(3) / quaternion math (port of ``voldor_tpu/ops/lie.py``).

All functions broadcast over leading batch dimensions. Conventions match
the JAX package: rvec is axis-angle, pose6 is ``[rvec(3), tvec(3)]`` with
``p_cam2 = R(rvec) @ p_cam1 + t``, quaternions are Hamilton ``[w, x, y, z]``.

Singularities are guarded with ``torch.where`` exactly as the JAX package
guards them: the branch that is not selected may compute 0/0, so forward
mode (``torch.func.jacfwd``) is the way to differentiate through them.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _hat(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric cross-product matrix."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, with broadcasting (written out: it also
    runs under torch.func's forward mode and vmap)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def so3_exp(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> rotation matrix (Rodrigues). (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(rvec * rvec, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS))
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    K = _hat(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye + a * K + b * (K @ K)


def rotate_rvec(p: torch.Tensor, rvec: torch.Tensor) -> torch.Tensor:
    """Rotate points by an axis-angle vector without building R
    (``lie.py:91``). p, rvec: (..., 3), broadcast."""
    theta2 = torch.sum(rvec * rvec, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS))
    small = theta2 < 1e-12
    safe_theta = torch.where(small, 1.0, theta)
    w = rvec / safe_theta
    # the trig runs before any indexing: torch.func's forward mode gives a
    # float64 tangent to a scalar product of an indexed zero tangent
    cos_t = torch.where(small, 1.0, torch.cos(theta))
    sin_t = torch.where(small, 0.0, torch.sin(theta))
    w_cross_p = cross(w, p)
    w_dot_p = torch.sum(w * p, dim=-1, keepdim=True)
    rotated = p * cos_t + w_cross_p * sin_t + w * w_dot_p * (1.0 - cos_t)
    linear = p + cross(rvec, p)
    return torch.where(small, linear, rotated)


def so3_right_jacobian(rvec: torch.Tensor) -> torch.Tensor:
    """Right Jacobian J_r of SO(3) (``lie.py:113``): exp((r+d)^) =
    exp(r^) exp((J_r(r) d)^). (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(rvec * rvec, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS))
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    K = _hat(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye - b * K + c * (K @ K)


def quat_from_rvec(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> unit quaternion [w,x,y,z] (``lie.py:171``)."""
    theta2 = torch.sum(rvec * rvec, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS))
    small = theta2 < 1e-12
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(0.5 * theta) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(0.5 * theta))
    return torch.cat([w, rvec * k], dim=-1)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, [w,x,y,z]."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate points p (..., 3) by unit quaternion q (..., 4) [w,x,y,z]."""
    w = q[..., 0:1]
    v = q[..., 1:]
    uv = cross(v, p)
    uuv = cross(v, uv)
    return p + 2.0 * (w * uv + uuv)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), _EPS)


def quat_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> unit quaternion [w,x,y,z], Shepperd's method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def cand(t, a, b, c, d):
        s = torch.sqrt(torch.clamp_min(t, _EPS)) * 2.0
        return torch.stack([a / s, b / s, c / s, d / s], dim=-1), s

    qw, sw = cand(tr + 1.0, tr + 1.0, m21 - m12, m02 - m20, m10 - m01)
    qx, sx = cand(1.0 + m00 - m11 - m22, m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20)
    qy, sy = cand(1.0 + m11 - m00 - m22, m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21)
    qz, sz = cand(1.0 + m22 - m00 - m11, m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11)

    scores = torch.stack([sw, sx, sy, sz], dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4)
    idx = torch.argmax(scores, dim=-1)
    q = torch.take_along_dim(cands, idx[..., None, None], dim=-2)[..., 0, :]
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    return quat_normalize(q)


def quat_to_rvec(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [w,x,y,z] -> axis-angle."""
    w = q[..., 0]
    xyz = q[..., 1:]
    sin_half = torch.linalg.norm(xyz, dim=-1)
    theta = 2.0 * torch.atan2(sin_half, w)
    small = sin_half < 1e-8
    w_div = torch.where(w == 0, torch.ones_like(w), torch.sign(w) + (w == 0).to(w.dtype))
    scale = torch.where(small, 2.0 / w_div, theta / torch.clamp_min(sin_half, _EPS))
    return xyz * scale[..., None]


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle, through a quaternion (atan2 angle)."""
    return quat_to_rvec(quat_from_matrix(R))


def pose6_to_T44(pose6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 4, 4) homogeneous transform."""
    T = torch.zeros(pose6.shape[:-1] + (4, 4), dtype=pose6.dtype, device=pose6.device)
    T[..., :3, :3] = so3_exp(pose6[..., :3])
    T[..., :3, 3] = pose6[..., 3:6]
    T[..., 3, 3] = 1.0
    return T


def T44_to_pose6(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6)."""
    return torch.cat([so3_log(T[..., :3, :3]), T[..., :3, 3]], dim=-1)


def T44_inv(T: torch.Tensor) -> torch.Tensor:
    """Closed-form rigid-transform inverse."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
    out[..., 3, 3] = 1.0
    return out
