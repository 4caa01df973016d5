"""Batched AP3P minimal pose solver, Ke & Roumeliotis, CVPR 2017 (port of
``voldor_tpu/ops/ap3p.py``: ``_solve_quartic`` :33, ``_ap3p_poses`` :101,
``_ap3p_p4p_single`` :188, ``solve_batch_p4p_ap3p`` :216).

The reference's second minimal solver (``--lambdatwist 0``). P3P reduces to
a quartic in cos(theta1'), solved by Ferrari's method in complex64 and
polished by Newton steps; each of the four roots gives an (R, t), and the
fourth point picks one by its reprojection. Every hypothesis is one element
of a batch shape S; the JAX package's per-instance branches are
``torch.where``s, and all four roots are always carried, invalid ones with
``ok=False``. The 4-subsets come in as indices (``p3p.draw_p4p_indices``),
so both minimal solvers can be fed the same draws.

Conventions match ops/p3p.py: solutions map world -> camera,
x_cam = R x_world + t.
"""

from __future__ import annotations

import torch

from voldor_tpu_torch.ops import lie
from voldor_tpu_torch.ops.fisk import div_scalar
from voldor_tpu_torch.ops.p3p import select_subsets

_POLISH_ITERS = 3


def _guard(x, eps):
    """x with |x| < eps replaced by eps."""
    return torch.where(torch.abs(x) < eps, eps, x)


def _cbrt(x):
    """Real cube root, rounded once from float64."""
    return (torch.sign(x) * torch.abs(x.double()).pow(1.0 / 3.0)).to(x.dtype)


def _solve_quartic(a4, a3, a2, a1, a0):
    """The real parts of the four roots of a4 x^4 + ... + a0, stacked on a
    new leading dim (Ferrari's method on the depressed quartic, then
    ``_POLISH_ITERS`` Newton steps). A complex pair comes out as its real
    part; the |cos| <= 1 gate and the reprojection vote reject it later."""
    a4 = _guard(a4, 1e-20)
    a4_2 = a4 * a4
    a3_2 = a3 * a3
    a4_3 = a4_2 * a4
    a2a4 = a2 * a4

    p4 = (8.0 * a2a4 - 3.0 * a3_2) / (8.0 * a4_2)
    q4 = (a3_2 * a3 - 4.0 * a2a4 * a3 + 8.0 * a1 * a4_2) / (8.0 * a4_3)
    r4 = (
        256.0 * a0 * a4_3 - 3.0 * a3_2 * a3_2 - 64.0 * a1 * a3 * a4_2
        + 16.0 * a2a4 * a3_2
    ) / (256.0 * a4_3 * a4)

    p3 = div_scalar(div_scalar(p4 * p4, 12.0) + r4, 3.0)
    q3 = div_scalar(72.0 * r4 * p4 - 2.0 * p4 * p4 * p4 - 27.0 * q4 * q4, 432.0)

    wroot = torch.sqrt((q3 * q3 - p3 * p3 * p3).to(torch.complex64))
    # the sign that avoids cancellation against -q3
    w = torch.where(q3 >= 0, -wroot, wroot) - q3

    # real cube root when w is real, the principal complex root otherwise
    w_is_real = torch.abs(w.imag) < 1e-12
    wr = _guard(w.real, 1e-20)
    cbrt_r = _cbrt(wr)
    t_real = 2.0 * (cbrt_r + p3 / cbrt_r)
    t_cplx = 4.0 * (w ** (1.0 / 3.0)).real
    t = torch.where(w_is_real, t_real, t_cplx)

    sqrt_2m = torch.sqrt((div_scalar(-2.0 * p4, 3.0) + t).to(torch.complex64))
    B_4A = -a3 / (4.0 * a4)
    c1 = (div_scalar(4.0 * p4, 3.0) + t).to(torch.complex64)
    sqrt_2m_safe = torch.where(torch.abs(sqrt_2m) < 1e-20, torch.full_like(sqrt_2m, 1e-20), sqrt_2m)
    c2 = 2.0 * q4 / sqrt_2m_safe

    sqrt_2m_rh = sqrt_2m.real * 0.5
    s1 = torch.sqrt(-(c1 + c2)).real * 0.5
    s2 = torch.sqrt(-(c1 - c2)).real * 0.5
    r = torch.stack([
        B_4A + sqrt_2m_rh + s1,
        B_4A + sqrt_2m_rh - s1,
        B_4A - sqrt_2m_rh + s2,
        B_4A - sqrt_2m_rh - s2,
    ])
    for _ in range(_POLISH_ITERS):  # solve_batch_ap3p.cu:86-99
        err = (((a4 * r + a3) * r + a2) * r + a1) * r + a0
        der = ((4.0 * a4 * r + 3.0 * a3) * r + 2.0 * a2) * r + a1
        r = r - err / _guard(der, 1e-20)
    return r


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _norm(a):
    return torch.linalg.norm(a, dim=-1)


def _ap3p_poses(b1, b2, b3, w1, w2, w3):
    """Up to 4 world -> camera (R, t) from three bearing / point pairs, each
    (S, 3) (``ap3p.py:101``, computePoses). Returns (Rs (S, 4, 3, 3), ts
    (S, 4, 3), ok (S, 4))."""
    u0 = w1 - w2
    nu0 = _norm(u0)
    k1 = u0 / torch.clamp_min(nu0, 1e-20)[..., None]

    k3 = _cross(b1, b2)
    nk3 = _norm(k3)
    k3 = k3 / torch.clamp_min(nk3, 1e-20)[..., None]
    tz = _cross(b1, k3)

    v1 = _cross(b1, b3)
    v2 = _cross(b2, b3)
    u1 = w1 - w3

    u1k1 = _dot(u1, k1)
    k3b3 = _dot(k3, b3)
    f11 = k3b3
    f13 = _dot(k3, v1)
    f15 = -u1k1 * f11

    nl = _cross(u1, k1)
    delta = _norm(nl)
    nl = nl / torch.clamp_min(delta, 1e-20)[..., None]
    f11 = f11 * delta
    f13 = f13 * delta

    u2k1 = u1k1 - nu0
    f21 = _dot(tz, v2)
    f22 = nk3 * k3b3
    f23 = _dot(k3, v2)
    f24 = u2k1 * f22
    f25 = -u2k1 * f21
    f21 = f21 * delta
    f22 = f22 * delta
    f23 = f23 * delta

    g1 = f13 * f22
    g2 = f13 * f25 - f15 * f23
    g3 = f11 * f23 - f13 * f21
    g4 = -f13 * f24
    g5 = f11 * f22
    g6 = f11 * f25 - f15 * f21
    g7 = -f15 * f24

    c = _solve_quartic(
        g5 * g5 + g1 * g1 + g3 * g3,
        2.0 * (g5 * g6 + g1 * g2 + g3 * g4),
        g6 * g6 + 2.0 * g5 * g7 + g2 * g2 + g4 * g4 - g1 * g1 - g3 * g3,
        2.0 * (g6 * g7 - g1 * g2 - g3 * g4),
        g7 * g7 - g2 * g2 - g4 * g4,
    ).movedim(0, -1)  # (S, 4) cos(theta1') candidates

    Ck1nl = torch.stack([k1, nl, _cross(k1, nl)], dim=-1)[..., None, :, :]  # columns
    Cb1k3tzT = torch.stack([b1, k3, tz], dim=-2)[..., None, :, :]  # rows
    b3p = (delta / _guard(k3b3, 1e-20))[..., None] * b3

    def bc(x):  # (S,) -> (S, 1), against the roots' (S, 4)
        return x[..., None]

    ok = torch.abs(c) <= 1.0
    st = torch.sqrt(torch.clamp_min(1.0 - c * c, 0.0))
    s1p = torch.where(bc(k3b3) > 0, st, -st)
    denom = (bc(g5) * c + bc(g6)) * c + bc(g7)
    ntheta3 = s1p / _guard(denom, 1e-20)
    c3 = (bc(g1) * c + bc(g2)) * ntheta3
    s3 = (bc(g3) * c + bc(g4)) * ntheta3
    zero = torch.zeros_like(c)
    C13 = torch.stack([
        torch.stack([c3, zero, -s3], dim=-1),
        torch.stack([s1p * s3, c, s1p * c3], dim=-1),
        torch.stack([c * s3, -s1p, c * c3], dim=-1),
    ], dim=-2)  # (S, 4, 3, 3)
    R = (Ck1nl @ C13 @ Cb1k3tzT).transpose(-1, -2)  # world -> camera
    t = s1p[..., None] * b3p[..., None, :] - (R @ w3[..., None, :, None])[..., 0]
    ok = ok & torch.isfinite(R).all(dim=(-2, -1)) & torch.isfinite(t).all(dim=-1)
    return R, t, ok


def _ap3p_p4p_batch(p2s, p3s, fx, fy, cx, cy):
    """Solve P4P instances p2s (S, 4, 2), p3s (S, 4, 3): AP3P on the first
    three, the fourth point's reprojection picks the root
    (``ap3p.py:188``). Returns (rvec (S, 3), t (S, 3), valid (S,))."""
    m = torch.stack(
        [div_scalar(p2s[..., :3, 0] - cx, fx), div_scalar(p2s[..., :3, 1] - cy, fy),
         torch.ones_like(p2s[..., :3, 0])], dim=-1,
    )
    b = m / _norm(m)[..., None]
    Rs, ts, oks = _ap3p_poses(
        b[..., 0, :], b[..., 1, :], b[..., 2, :], p3s[..., 0, :], p3s[..., 1, :], p3s[..., 2, :]
    )
    x4 = p3s[..., 3, :]
    proj = (Rs @ x4[..., None, :, None])[..., 0] + ts  # (S, 4, 3)
    z = _guard(proj[..., 2], 1e-12)
    du = cx + fx * proj[..., 0] / z - p2s[..., 3:4, 0]
    dv = cy + fy * proj[..., 1] / z - p2s[..., 3:4, 1]
    reproj = torch.where(oks, du * du + dv * dv, torch.inf)
    best = torch.argmin(reproj, dim=-1)
    R = torch.take_along_dim(Rs, best[..., None, None, None], dim=-3)[..., 0, :, :]
    t = torch.take_along_dim(ts, best[..., None, None], dim=-2)[..., 0, :]
    best_err = torch.take_along_dim(reproj, best[..., None], dim=-1)[..., 0]
    valid = oks.any(dim=-1) & torch.isfinite(best_err)
    rvec = lie.so3_log(R)
    valid = valid & torch.isfinite(rvec).all(dim=-1) & torch.isfinite(t).all(dim=-1)
    return rvec, t, valid


def solve_batch_p4p_ap3p(p2s, p3s, valid, idx, fx, fy, cx, cy):
    """AP3P in place of ``p3p.solve_batch_p4p``, with the same arguments and
    return: the subsets ``idx`` of the valid correspondences solved, (rvecs
    (..., n_poses, 3), tvecs (..., n_poses, 3), ok (..., n_poses))."""
    rvecs, tvecs, ok = _ap3p_p4p_batch(*select_subsets(p2s, p3s, valid, idx), fx, fy, cx, cy)
    ok = ok & (valid.sum(dim=-1) >= 4)[..., None]
    return rvecs, tvecs, ok
