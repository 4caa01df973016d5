"""Batched LambdaTwist P3P / P4P minimal pose solver
(port of ``voldor_tpu/ops/p3p.py``: ``solve_batch_p4p`` :300 with
``_p4p_single`` :175 and its helpers).

The JAX package solves every hypothesis in one jitted program (a vmap of
``_p4p_single``). Here:

* ``solve_batch_p4p`` / ``solve_batch_p4p_pool`` -- the wrappers. For CUDA
  tensors they launch the hand-written kernel (``csrc/p4p_kernel.cu``), a
  thread per hypothesis; ``solve_batch_p4p_pool`` has it write the
  meanshift pool row [rvec * rvec_scale, t] and its 0 / 1 validity
  directly. For CPU tensors they call the plain versions. There is no
  fallback from one to the other.
* ``solve_batch_p4p_reference`` -- the plain version: every hypothesis is
  one element of a batch shape S, the JAX package's per-instance scalars
  become (S,)-shaped tensors and each data-dependent branch a
  ``torch.where``.

Failed solutions surface as ``ok=False``. The random 4-subset draw and the
stable compaction of the valid correspondences stay outside the kernel
(``draw_p4p_indices``, ``select_subsets``).
"""

from __future__ import annotations

import ctypes

import torch

from voldor_tpu_torch.ops import _build, lie
from voldor_tpu_torch.ops.fisk import div_scalar

_CUBIC_ITERS = 24
_REFINE_ITERS = 5

# Calls that launched the CUDA kernel since the last reset (plain int;
# chip_smoke.py reads it to show the main path went through the kernel).
p4p_kernel_launches = 0

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float] * 5 + [_P] * 5 + [_P]


def _sqrt(x):
    """The correctly rounded square root, as IEEE ``sqrtf`` takes it on the
    card. PyTorch's vectorised CPU sqrt is not always correctly rounded,
    and the cubic's Newton steps amplify that last bit on an ill-conditioned
    subset; the float64 root rounded to float32 is correctly rounded."""
    return torch.sqrt(x.double()).to(x.dtype)


def _nz(x, eps=1e-30):
    """x with |x| < eps replaced by eps (the reference's division guard)."""
    return torch.where(torch.abs(x) < eps, eps, x)


def _root2real(b, c):
    """Stable real roots of x^2 + b x + c: (r1, r2, has_real)."""
    v = b * b - 4.0 * c
    has_real = v >= 0
    y = _sqrt(torch.clamp_min(v, 0.0))
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
    v = _sqrt(torch.clamp_min(disc, 0.0))
    t1 = div_scalar(-b - v, 3.0)
    t2 = div_scalar(-b + v, 3.0)
    k1 = h(t1)
    k2 = h(t2)
    r0_a = t1 - _sqrt(torch.clamp_min(-k1 / (3.0 * t1 + b), 0.0))
    r0_b = t2 + _sqrt(torch.clamp_min(-k2 / (3.0 * t2 + b), 0.0))
    r0_stat = torch.where(k1 > 0.0, r0_a, r0_b)
    r0_mono = div_scalar(-b, 3.0)
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


def _dot(a, b):
    """a . b of two 3-vectors given as component tuples, added in turn."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    """a x b of two 3-vectors given as component tuples (``lie.cross``)."""
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _sub(a, b):
    return tuple(p - q for p, q in zip(a, b))


def _scale(a, s):
    return tuple(p * s for p in a)


def _matvec(R, x):
    """R x, R as three row tuples, each entry a ``_dot``."""
    return tuple(_dot(row, x) for row in R)


def _matmul(Y, X):
    """Y X for Y given as three column tuples and X as three row tuples,
    each entry a ``_dot`` of a row of Y and a column of X."""
    return tuple(tuple(_dot((Y[0][i], Y[1][i], Y[2][i]), (X[0][j], X[1][j], X[2][j]))
                       for j in range(3)) for i in range(3))


def _p4p_batch(p2s, p3s, fx, fy, cx, cy):
    """Solve a batch of P4P instances.

    p2s: (S, 4, 2) pixels; p3s: (S, 4, 3) points. Returns (rvec (S, 3),
    t (S, 3), valid (S,)) with p_cam = R p_world + t.

    Vectors are tuples of (S,)-shaped components and every product, sum,
    division and square root is one correctly rounded float32 operation in
    the JAX package's expression order, its norms and dot products added
    in turn. ``csrc/p4p_kernel.cu`` repeats it operation for operation.
    """

    def bearing(i):
        bx = div_scalar(p2s[..., i, 0] - cx, fx)
        by = div_scalar(p2s[..., i, 1] - cy, fy)
        n = _sqrt(bx * bx + by * by + 1.0)
        return bx / n, by / n, 1.0 / n

    def point(i):
        return p3s[..., i, 0], p3s[..., i, 1], p3s[..., i, 2]

    y1, y2, y3 = bearing(0), bearing(1), bearing(2)
    x1, x2, x3, x4 = point(0), point(1), point(2), point(3)

    b12 = -2.0 * _dot(y1, y2)
    b13 = -2.0 * _dot(y1, y3)
    b23 = -2.0 * _dot(y2, y3)
    d12 = _sub(x1, x2)
    d13 = _sub(x1, x3)
    d23 = _sub(x2, x3)
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
        rnorm = 1.0 / _sqrt(w0 * w0 + w1 * w1 + 1.0)
        return w0 * rnorm, w1 * rnorm, rnorm

    V00, V10, V20 = eigvec(e1)  # column 0
    V01, V11, V21 = eigvec(e2)  # column 1
    v = _sqrt(torch.clamp_min(-e2 / _nz(e1), 0.0))

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
            l2 = _sqrt(torch.clamp_min(d, 0.0))
            l3 = tau * l2
            l1 = w0 * l2 + w1 * l3
            return l1, l2, l3, ok & (l1 >= 0)

        return from_tau(tau1), from_tau(tau2)

    (LA, LB), (LC, LD) = lambda_candidates(v), lambda_candidates(-v)

    # X's inverse: the rows c0, c1, c2 (cofactors of its columns d12, d13,
    # d12 x d13) over its determinant
    c0 = _cross(d13, d12xd13)
    c1 = _cross(d12xd13, d12)
    c2 = _cross(d12, d13)
    detX = _nz(_dot(d12, c0))
    Xinv = tuple(tuple(q / detX for q in c) for c in (c0, c1, c2))

    # each candidate's pose and its 4th-point reprojection error; the first
    # smallest error wins (torch.argmin's tie rule)
    best = None
    oks = []
    for cand in (LA, LB, LC, LD):
        l1, l2, l3 = _gn_refine_lambdas(*cand, a12, a13, a23, b12, b13, b23)
        oks.append(cand[3])
        ry1, ry2, ry3 = _scale(y1, l1), _scale(y2, l2), _scale(y3, l3)
        yd1 = _sub(ry1, ry2)
        yd2 = _sub(ry1, ry3)
        Y = (yd1, yd2, _cross(yd1, yd2))  # columns
        R = _matmul(Y, Xinv)
        t = _sub(ry1, _matvec(R, x1))
        p4 = tuple(q + ti for q, ti in zip(_matvec(R, x4), t))
        z4 = _nz(p4[2])
        du = cx + fx * p4[0] / z4 - p2s[..., 3, 0]
        dv = cy + fy * p4[1] / z4 - p2s[..., 3, 1]
        reproj = du * du + dv * dv
        reproj = torch.where(cand[3] & torch.isfinite(reproj), reproj, torch.inf)
        if best is None:
            best = R, t, reproj
        else:
            take = reproj < best[2]
            best = (tuple(tuple(torch.where(take, a, b) for a, b in zip(ra, rb))
                          for ra, rb in zip(R, best[0])),
                    tuple(torch.where(take, a, b) for a, b in zip(t, best[1])),
                    torch.where(take, reproj, best[2]))
    R, t, best_err = best
    t = torch.stack(t, dim=-1)
    valid = torch.stack(oks, dim=-1).any(dim=-1) & torch.isfinite(best_err)
    rvec = lie.so3_log(torch.stack([torch.stack(row, dim=-1) for row in R], dim=-2))
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


def solve_batch_p4p_reference(p2s, p3s, valid, idx, fx, fy, cx, cy):
    """The plain version of ``solve_batch_p4p`` (same arguments and result)."""
    rvecs, tvecs, ok = _p4p_batch(*select_subsets(p2s, p3s, valid, idx), fx, fy, cx, cy)
    ok = ok & (valid.sum(dim=-1) >= 4)[..., None]
    return rvecs, tvecs, ok


def solve_batch_p4p_pool_reference(p2s, p3s, valid, idx, fx, fy, cx, cy, rvec_scale: float):
    """The plain version of ``solve_batch_p4p_pool``."""
    rvecs, tvecs, ok = solve_batch_p4p_reference(p2s, p3s, valid, idx, fx, fy, cx, cy)
    return torch.cat([rvecs * rvec_scale, tvecs], dim=-1), ok.to(torch.float32)


def _launch(p2s, p3s, valid, idx, fx, fy, cx, cy, rvec_scale=None):
    """The kernel on CUDA tensors: (rvecs, tvecs, ok), or with
    ``rvec_scale`` the meanshift pool (pool (..., n, 6) = [rvec *
    rvec_scale, t], pool_valid (..., n) float32 0 / 1)."""
    dev = p2s.device
    lead, M = valid.shape[:-1], valid.shape[-1]
    S = idx.shape[-2]
    if p2s.shape != lead + (M, 2) or p3s.shape != lead + (M, 3) or idx.shape != lead + (S, 4):
        raise ValueError(f"solve_batch_p4p: shapes p2s {tuple(p2s.shape)}, p3s {tuple(p3s.shape)}, "
                         f"valid {tuple(valid.shape)}, idx {tuple(idx.shape)} do not match")
    if M < 1:
        raise ValueError("solve_batch_p4p kernel takes M >= 1 correspondences")
    B = 1
    for n in lead:
        B *= n
    for name, x in (("p3s", p3s), ("valid", valid), ("idx", idx)):
        if x.device != dev:
            raise ValueError(f"solve_batch_p4p: {name} is on {x.device}, p2s on {dev}")
    valid = valid.to(torch.bool)
    # the stable compaction of select_subsets: valid rows first, in order
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True).reshape(B, M)
    n_valid = valid.sum(dim=-1, dtype=torch.int32).reshape(B)
    p2 = p2s.to(torch.float32).reshape(B, M, 2).contiguous()
    p3 = p3s.to(torch.float32).reshape(B, M, 3).contiguous()
    ix = idx.to(torch.int64).reshape(B, S, 4).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    null = None
    if rvec_scale is None:
        outs = (torch.empty((B, S, 3), **f32), torch.empty((B, S, 3), **f32),
                torch.empty((B, S), dtype=torch.bool, device=dev), null, null)
    else:
        outs = (null, null, null, torch.empty((B, S, 6), **f32), torch.empty((B, S), **f32))
    global p4p_kernel_launches
    fn = _build.function("p4p_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(p2.data_ptr(), p3.data_ptr(), order.data_ptr(), ix.data_ptr(), n_valid.data_ptr(),
                 B, M, S, fx, fy, cx, cy, 0.0 if rvec_scale is None else rvec_scale,
                 *(0 if o is None else o.data_ptr() for o in outs),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"p4p kernel launch failed: cudaError {err}")
    p4p_kernel_launches += 1
    if rvec_scale is None:
        return outs[0].reshape(lead + (S, 3)), outs[1].reshape(lead + (S, 3)), outs[2].reshape(lead + (S,))
    return outs[3].reshape(lead + (S, 6)), outs[4].reshape(lead + (S,))


def _check_device(p2s):
    if p2s.device.type != "cuda":
        raise ValueError(f"solve_batch_p4p: unsupported device {p2s.device}")


def solve_batch_p4p(p2s, p3s, valid, idx, fx, fy, cx, cy):
    """Solve the P4P subsets ``idx`` drawn from the valid correspondences.

    p2s: (..., M, 2); p3s: (..., M, 3); valid: (..., M) bool; idx:
    (..., n_poses, 4) indices into the valid entries in their original
    order (``draw_p4p_indices``). Returns (rvecs (..., n_poses, 3), tvecs
    (..., n_poses, 3), ok (..., n_poses)). CPU tensors take the plain
    version; CUDA tensors launch the kernel, a thread per hypothesis.
    """
    if p2s.device.type == "cpu":
        return solve_batch_p4p_reference(p2s, p3s, valid, idx, fx, fy, cx, cy)
    _check_device(p2s)
    return _launch(p2s, p3s, valid, idx, fx, fy, cx, cy)


def solve_batch_p4p_pool(p2s, p3s, valid, idx, fx, fy, cx, cy, rvec_scale: float):
    """``solve_batch_p4p`` as the meanshift pool: (pool (..., n_poses, 6) =
    [rvecs * rvec_scale, tvecs], pool_valid (..., n_poses) float32 0 / 1,
    the ok flags). On the card the kernel writes both directly."""
    if p2s.device.type == "cpu":
        return solve_batch_p4p_pool_reference(p2s, p3s, valid, idx, fx, fy, cx, cy, rvec_scale)
    _check_device(p2s)
    return _launch(p2s, p3s, valid, idx, fx, fy, cx, cy, rvec_scale)
