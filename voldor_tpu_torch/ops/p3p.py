"""Batched LambdaTwist P3P / P4P minimal pose solver
(port of ``voldor_tpu/ops/p3p.py``: ``solve_batch_p4p`` :300 with
``_p4p_single`` :175 and its helpers).

Every hypothesis is one element of a batch shape S; the JAX package's
per-instance scalars become (S,)-shaped tensors and each data-dependent
branch a ``torch.where``. Failed solutions surface as ``ok=False``. The
random 4-subset draw is split out (``draw_p4p_indices``).
"""

from __future__ import annotations

import torch

from voldor_tpu_torch.ops import lie

_CUBIC_ITERS = 24
_REFINE_ITERS = 5


def _nz(x, eps=1e-30):
    """x with |x| < eps replaced by eps (the reference's division guard)."""
    return torch.where(torch.abs(x) < eps, eps, x)


def _root2real(b, c):
    """Stable real roots of x^2 + b x + c: (r1, r2, has_real)."""
    v = b * b - 4.0 * c
    has_real = v >= 0
    y = torch.sqrt(torch.clamp_min(v, 0.0))
    r1_neg = 0.5 * (-b + y)
    r2_neg = 0.5 * (-b - y)
    r1_pos = 2.0 * c / _nz(-b + y)
    r2_pos = 2.0 * c / _nz(-b - y)
    r1 = torch.where(b < 0, r1_neg, r1_pos)
    r2 = torch.where(b < 0, r2_neg, r2_pos)
    r1 = torch.where(has_real, r1, 0.5 * b)
    r2 = torch.where(has_real, r2, 0.5 * b)
    return r1, r2, has_real


def _cubick(b, c, d):
    """Most-stable real root of x^3 + b x^2 + c x + d."""

    def h(r):
        return ((r + b) * r + c) * r + d

    def hp(r):
        return (3.0 * r + 2.0 * b) * r + c

    disc = b * b - 3.0 * c
    v = torch.sqrt(torch.clamp_min(disc, 0.0))
    t1 = (-b - v) / 3.0
    t2 = (-b + v) / 3.0
    k1 = h(t1)
    k2 = h(t2)
    r0_a = t1 - torch.sqrt(torch.clamp_min(-k1 / (3.0 * t1 + b), 0.0))
    r0_b = t2 + torch.sqrt(torch.clamp_min(-k2 / (3.0 * t2 + b), 0.0))
    r0_stat = torch.where(k1 > 0.0, r0_a, r0_b)
    r0_mono = -b / 3.0
    r0_mono = torch.where(torch.abs(hp(r0_mono)) < 1e-4, r0_mono + 1.0, r0_mono)
    r = torch.where(disc >= 0.0, r0_stat, r0_mono)
    for _ in range(_CUBIC_ITERS):
        r = r - h(r) / _nz(hp(r))
    return r


def _gn_refine_lambdas(l1, l2, l3, valid, a12, a13, a23, b12, b13, b23):
    """Gauss-Newton refinement of a depth triple with accept-if-better
    gating (refine_lambda.h semantics, ``p3p.py:120``)."""

    def residuals(l1, l2, l3):
        r1 = l1 * l1 + l2 * l2 + b12 * l1 * l2 - a12
        r2 = l1 * l1 + l3 * l3 + b13 * l1 * l3 - a13
        r3 = l2 * l2 + l3 * l3 + b23 * l2 * l3 - a23
        return r1, r2, r3

    o1, o2, o3 = l1, l2, l3
    frozen = torch.zeros_like(valid)
    for _ in range(_REFINE_ITERS):
        r1, r2, r3 = residuals(l1, l2, l3)
        rsum = torch.abs(r1) + torch.abs(r2) + torch.abs(r3)
        converged = rsum < 1e-10
        v0 = 2.0 * l1 + b12 * l2
        v1 = 2.0 * l2 + b12 * l1
        v3 = 2.0 * l1 + b13 * l3
        v5 = 2.0 * l3 + b13 * l1
        v7 = 2.0 * l2 + b23 * l3
        v8 = 2.0 * l3 + b23 * l2
        det = -v0 * v5 * v7 - v1 * v3 * v8
        det_inv = 1.0 / _nz(det)
        # Ji @ r, row by row
        j1 = -v5 * v7 * r1 + -v1 * v8 * r2 + v1 * v5 * r3
        j2 = -v3 * v8 * r1 + v0 * v8 * r2 + -v0 * v5 * r3
        j3 = v3 * v7 * r1 + -v0 * v7 * r2 + -v1 * v3 * r3
        n1 = l1 - det_inv * j1
        n2 = l2 - det_inv * j2
        n3 = l3 - det_inv * j3
        q1, q2, q3 = residuals(n1, n2, n3)
        worse = (torch.abs(q1) + torch.abs(q2) + torch.abs(q3)) > rsum
        accept = ~frozen & ~converged & ~worse
        l1 = torch.where(accept, n1, l1)
        l2 = torch.where(accept, n2, l2)
        l3 = torch.where(accept, n3, l3)
        frozen = frozen | converged | worse
    return (torch.where(valid, l1, o1), torch.where(valid, l2, o2), torch.where(valid, l3, o3))


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _p4p_batch(p2s, p3s, fx, fy, cx, cy):
    """Solve a batch of P4P instances.

    p2s: (S, 4, 2) pixels; p3s: (S, 4, 3) points. Returns (rvec (S, 3),
    t (S, 3), valid (S,)) with p_cam = R p_world + t.
    """
    ones = torch.ones_like(p2s[..., 0])
    y = torch.stack([(p2s[..., 0] - cx) / fx, (p2s[..., 1] - cy) / fy, ones], dim=-1)
    y = y / torch.linalg.norm(y, dim=-1, keepdim=True)
    y1, y2, y3 = y[..., 0, :], y[..., 1, :], y[..., 2, :]
    x1, x2, x3 = p3s[..., 0, :], p3s[..., 1, :], p3s[..., 2, :]

    b12 = -2.0 * _dot(y1, y2)
    b13 = -2.0 * _dot(y1, y3)
    b23 = -2.0 * _dot(y2, y3)
    d12 = x1 - x2
    d13 = x1 - x3
    d23 = x2 - x3
    d12xd13 = _cross(d12, d13)
    a12 = _dot(d12, d12)
    a13 = _dot(d13, d13)
    a23 = _dot(d23, d23)

    c31 = -0.5 * b13
    c23 = -0.5 * b23
    c12 = -0.5 * b12
    blob = c12 * c23 * c31 - 1.0
    s31s = 1.0 - c31 * c31
    s23s = 1.0 - c23 * c23
    s12s = 1.0 - c12 * c12

    p3 = a13 * (a23 * s31s - a13 * s23s)
    p2 = 2.0 * blob * a23 * a13 + a13 * (2.0 * a12 + a13) * s23s + a23 * (a23 - a12) * s31s
    p1 = a23 * (a13 - a23) * s12s - a12 * a12 * s23s - 2.0 * a12 * (blob * a23 + a13 * s23s)
    p0 = a12 * (a12 * s23s - a23 * s12s)
    p3_inv = 1.0 / _nz(p3)
    g = _cubick(p2 * p3_inv, p1 * p3_inv, p0 * p3_inv)

    # A (symmetric 3x3), eig with a known zero eigenvalue (solve_eig0.h);
    # only the first two eigenvectors are used
    A00 = a23 * (1.0 - g)
    A01 = (a23 * b12) * 0.5
    A02 = (a23 * b13 * g) * (-0.5)
    A11 = a23 - a12 + a13 * g
    A12 = b23 * (a13 * g - a12) * 0.5
    A22 = g * (a13 - a23) - a12
    eb = -A00 - A11 - A22
    ec = -A01 * A01 - A02 * A02 - A12 * A12 + A00 * (A11 + A22) + A11 * A22
    e1, e2, _ = _root2real(eb, ec)
    swap = torch.abs(e1) < torch.abs(e2)
    e1, e2 = torch.where(swap, e2, e1), torch.where(swap, e1, e2)
    mx0011 = -A00 * A11
    prec_0 = A01 * A12 - A02 * A11
    prec_1 = A01 * A02 - A00 * A12

    def eigvec(e):
        tmp = 1.0 / (e * (A00 + A11) + mx0011 - e * e + A01 * A01)
        w0 = -(e * A02 + prec_0) * tmp
        w1 = -(e * A12 + prec_1) * tmp
        rnorm = 1.0 / torch.sqrt(w0 * w0 + w1 * w1 + 1.0)
        return w0 * rnorm, w1 * rnorm, rnorm

    V00, V10, V20 = eigvec(e1)  # column 0
    V01, V11, V21 = eigvec(e2)  # column 1
    v = torch.sqrt(torch.clamp_min(-e2 / _nz(e1), 0.0))

    def lambda_candidates(s):
        w2 = 1.0 / _nz(s * V01 - V00)
        w0 = (V10 - s * V11) * w2
        w1 = (V20 - s * V21) * w2
        a = 1.0 / _nz((a13 - a12) * w1 * w1 - a12 * b13 * w1 - a12)
        b = (a13 * b12 * w1 - a12 * b13 * w0 - 2.0 * w0 * w1 * (a12 - a13)) * a
        c = ((a13 - a12) * w0 * w0 + a13 * b12 * w0 + a13) * a
        tau1, tau2, has_real = _root2real(b, c)

        def from_tau(tau):
            d = a23 / (tau * (b23 + tau) + 1.0)
            ok = has_real & (tau > 0) & (d > 0)
            l2 = torch.sqrt(torch.clamp_min(d, 0.0))
            l3 = tau * l2
            l1 = w0 * l2 + w1 * l3
            return l1, l2, l3, ok & (l1 >= 0)

        return from_tau(tau1), from_tau(tau2)

    (LA, LB), (LC, LD) = lambda_candidates(v), lambda_candidates(-v)
    cand = [LA, LB, LC, LD]
    Ls = [_gn_refine_lambdas(c[0], c[1], c[2], c[3], a12, a13, a23, b12, b13, b23) for c in cand]
    oks = torch.stack([c[3] for c in cand], dim=-1)  # (S, 4)

    X = torch.stack([d12, d13, d12xd13], dim=-1)  # columns
    c0 = _cross(X[..., :, 1], X[..., :, 2])
    c1 = _cross(X[..., :, 2], X[..., :, 0])
    c2 = _cross(X[..., :, 0], X[..., :, 1])
    detX = _dot(X[..., :, 0], c0)
    Xinv = torch.stack([c0, c1, c2], dim=-2) / _nz(detX)[..., None, None]

    Rs, ts = [], []
    for l1, l2, l3 in Ls:
        ry1 = y1 * l1[..., None]
        ry2 = y2 * l2[..., None]
        ry3 = y3 * l3[..., None]
        yd1 = ry1 - ry2
        yd2 = ry1 - ry3
        Y = torch.stack([yd1, yd2, _cross(yd1, yd2)], dim=-1)
        R = Y @ Xinv
        Rs.append(R)
        ts.append(ry1 - (R @ x1[..., None])[..., 0])
    Rs = torch.stack(Rs, dim=-3)  # (S, 4, 3, 3)
    ts = torch.stack(ts, dim=-2)  # (S, 4, 3)

    x4 = p3s[..., 3, :]
    p4 = (Rs @ x4[..., None, :, None])[..., 0] + ts  # (S, 4, 3)
    z4 = _nz(p4[..., 2])
    u4 = cx + fx * p4[..., 0] / z4
    v4 = cy + fy * p4[..., 1] / z4
    reproj = (u4 - p2s[..., 3:4, 0]) ** 2 + (v4 - p2s[..., 3:4, 1]) ** 2
    reproj = torch.where(oks & torch.isfinite(reproj), reproj, torch.inf)
    best = torch.argmin(reproj, dim=-1)
    R = torch.take_along_dim(Rs, best[..., None, None, None], dim=-3)[..., 0, :, :]
    t = torch.take_along_dim(ts, best[..., None, None], dim=-2)[..., 0, :]
    best_err = torch.take_along_dim(reproj, best[..., None], dim=-1)[..., 0]
    valid = oks.any(dim=-1) & torch.isfinite(best_err)
    rvec = lie.so3_log(R)
    valid = valid & torch.isfinite(rvec).all(dim=-1) & torch.isfinite(t).all(dim=-1)
    return rvec, t, valid


def draw_p4p_indices(gen: torch.Generator, valid: torch.Tensor, n_poses: int) -> torch.Tensor:
    """Uniform 4-subset indices into the compacted valid set: (..., n_poses, 4)
    int64 in [0, max(n_valid, 1)). ``valid``: (..., M) bool."""
    n_valid = torch.clamp_min(valid.sum(dim=-1), 1)
    u = torch.rand(valid.shape[:-1] + (n_poses, 4), generator=gen, device=valid.device)
    idx = (u * n_valid[..., None, None].to(u.dtype)).long()
    return torch.minimum(idx, (n_valid - 1)[..., None, None])


def select_subsets(p2s, p3s, valid, idx):
    """The 4-subsets ``idx`` ((..., n_poses, 4) indices into the valid
    entries in their original order) as (..., n_poses, 4, 2) pixels and
    (..., n_poses, 4, 3) points."""
    lead = valid.shape[:-1]
    n = idx.shape[-2]
    # stable: valid entries first, in order (argsort(~valid) in JAX)
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    sel = torch.take_along_dim(order, idx.long().reshape(lead + (n * 4,)), dim=-1)
    p2_sets = torch.take_along_dim(p2s, sel[..., None], dim=-2).reshape(lead + (n, 4, 2))
    p3_sets = torch.take_along_dim(p3s, sel[..., None], dim=-2).reshape(lead + (n, 4, 3))
    return p2_sets, p3_sets


def solve_batch_p4p(p2s, p3s, valid, idx, fx, fy, cx, cy):
    """Solve the P4P subsets ``idx`` drawn from the valid correspondences.

    p2s: (..., M, 2); p3s: (..., M, 3); valid: (..., M) bool; idx:
    (..., n_poses, 4) indices into the valid entries in their original
    order (``draw_p4p_indices``). Returns (rvecs (..., n_poses, 3), tvecs
    (..., n_poses, 3), ok (..., n_poses)).
    """
    rvecs, tvecs, ok = _p4p_batch(*select_subsets(p2s, p3s, valid, idx), fx, fy, cx, cy)
    ok = ok & (valid.sum(dim=-1) >= 4)[..., None]
    return rvecs, tvecs, ok
