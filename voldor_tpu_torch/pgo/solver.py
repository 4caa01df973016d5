"""Pose-graph optimisation over 7-DoF vertices (SE(3) + log scale)
(port of ``voldor_tpu/pgo/solver.py``).

Levenberg-Marquardt with either a dense normal-equation Cholesky per
iteration (``pgo_solve_dense_jit``) or matrix-free preconditioned conjugate
gradients (``pgo_solve_jit``). Per-edge Jacobians are taken in forward mode
(``torch.func.jvp``, as the JAX package's ``jax.jacfwd``): the small-angle
branches of the Lie maps compute 0/0 in the branch that is not selected,
which forward mode steps over and reverse mode would not.

Residual parity with PoseGraph3dErrorTerm including the begin/end swap,
the quaternion local parameterisation, the fixed-unless-7dof scale blocks
and the gauge fix of the first pose. State: p (N, 3), q (N, 4) unit
quaternion [w,x,y,z], s (N,) log scale.

The JAX package pads poses and edges to power-of-two buckets to bound its
compiled executables (``_pad_to_bucket``, solver.py:343-358); the port
solves the graph as it is.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from voldor_tpu_torch.ops import lie

# iterations between two reads of the done flag (the loop freezes the state
# once done, so the count does not change the result)
CHECK_EVERY = 4


class PgoProblem(NamedTuple):
    p: torch.Tensor  # (N, 3)
    q: torch.Tensor  # (N, 4) wxyz
    s: torch.Tensor  # (N,)
    edges_idx: torch.Tensor  # (M, 2) int64 (begin, end)
    meas_p: torch.Tensor  # (M, 3)
    meas_q: torch.Tensor  # (M, 4)
    meas_s: torch.Tensor  # (M,)
    sqrt_info: torch.Tensor  # (M, 7, 7)
    free_mask: torch.Tensor  # (N, 7) float: tangent dims free to move


def _edge_residual(p_a, q_a, s_a, p_b, q_b, s_b, meas_p, meas_q, meas_s, sqrt_info):
    """Whitened 7-residuals (``solver.py:47``), batched over leading axes.
    'a' is the END pose, 'b' the BEGIN pose (the reference swaps them)."""
    s_ab_avg = torch.sqrt(torch.exp(s_a + s_b))
    q_a_inv = lie.quat_conj(q_a)
    q_ab = lie.quat_mul(q_a_inv, q_b)
    p_ab = lie.quat_rotate(q_a_inv, (p_b - p_a) / s_ab_avg[..., None])
    delta_q = lie.quat_mul(meas_q, lie.quat_conj(q_ab))
    res = torch.cat([p_ab - meas_p, 2.0 * delta_q[..., 1:4], ((s_a - s_b) - meas_s)[..., None]],
                    dim=-1)
    return torch.einsum("mij,...mj->...mi", sqrt_info, res)


def _retract(p, q, s, delta):
    """Apply (..., 7) tangent steps [dp(3), dtheta(3), ds(1)] (``solver.py:65``)."""
    dq = lie.quat_from_rvec(delta[..., 3:6])
    return p + delta[..., :3], lie.quat_normalize(lie.quat_mul(dq, q)), s + delta[..., 6]


def _edge_residuals(prob: PgoProblem, d_e=None, d_b=None):
    """(..., M, 7) residuals of every edge with its end and begin poses
    moved by the tangent steps d_e, d_b (..., M, 7)."""
    ib, ie = prob.edges_idx[:, 0], prob.edges_idx[:, 1]
    p_b, q_b, s_b = prob.p[ib], prob.q[ib], prob.s[ib]
    p_e, q_e, s_e = prob.p[ie], prob.q[ie], prob.s[ie]
    if d_e is not None:
        p_e, q_e, s_e = _retract(p_e, q_e, s_e, d_e)
        p_b, q_b, s_b = _retract(p_b, q_b, s_b, d_b)
    return _edge_residual(p_e, q_e, s_e, p_b, q_b, s_b, prob.meas_p, prob.meas_q, prob.meas_s,
                          prob.sqrt_info)


def _edge_res_and_jacs(prob: PgoProblem):
    """Residuals (M, 7) and forward-mode Jacobians w.r.t. the two endpoint
    tangents ((M, 7, 7) each, columns masked by free_mask)
    (``solver.py:72``). One ``torch.func.jvp`` carries all 14 tangent
    columns of every edge at once, on a leading axis of 14: the edges are
    independent, so column k of every edge's Jacobian is the directional
    derivative along unit vector k, applied to all edges together."""
    M = prob.edges_idx.shape[0]
    z = torch.zeros((14, M, 7), dtype=prob.p.dtype, device=prob.p.device)
    basis = torch.eye(14, dtype=prob.p.dtype, device=prob.p.device)[:, None, :].expand(14, M, 14)
    r, J = torch.func.jvp(lambda d_e, d_b: _edge_residuals(prob, d_e, d_b), (z, z),
                          (basis[..., :7], basis[..., 7:]))
    J_e = J[:7].permute(1, 2, 0)  # (M, residual, tangent)
    J_b = J[7:].permute(1, 2, 0)
    fm_b = prob.free_mask[prob.edges_idx[:, 0]]
    fm_e = prob.free_mask[prob.edges_idx[:, 1]]
    return r[0], J_e * fm_e[:, None, :], J_b * fm_b[:, None, :]


def _cost(prob: PgoProblem):
    """0.5 |r|^2 over every edge, residuals only (``solver.py:127``)."""
    r = _edge_residuals(prob)
    return 0.5 * torch.sum(r * r)


def _apply_step(prob: PgoProblem, step):
    p, q, s = _retract(prob.p, prob.q, prob.s, -step)
    return prob._replace(p=p, q=q, s=s)


def _lm_loop(prob: PgoProblem, max_iters: int, body):
    """The LM loop of both solvers: state (prob, lam, cost, it, done),
    ``body`` advances it once; a done state is frozen, and the host reads
    the done flag every CHECK_EVERY iterations. Returns (prob, cost, iters)."""
    dev = prob.p.device
    lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    it = torch.tensor(0, dtype=torch.int32, device=dev)
    done = torch.tensor(False, device=dev)
    cost = _cost(prob)
    n = 0
    while n < max_iters:
        for _ in range(min(CHECK_EVERY, max_iters - n)):
            nprob, nlam, ncost, ndone = body(prob, lam, cost)
            active = ~done
            prob = prob._replace(p=torch.where(active, nprob.p, prob.p),
                                 q=torch.where(active, nprob.q, prob.q),
                                 s=torch.where(active, nprob.s, prob.s))
            lam = torch.where(active, nlam, lam)
            cost = torch.where(active, ncost, cost)
            it = it + active.to(torch.int32)
            done = done | ndone
        n += CHECK_EVERY
        if bool(done):
            break
    return prob, cost, it


def _accept(prob, trial, lam, cost, new_cost, ok):
    """Accept or reject a trial and adapt the damping (``solver.py:202-211``)."""
    accept = ok & torch.isfinite(new_cost) & (new_cost < cost)
    prob = prob._replace(
        p=torch.where(accept, trial.p, prob.p),
        q=torch.where(accept, trial.q, prob.q),
        s=torch.where(accept, trial.s, prob.s),
    )
    lam = torch.where(accept, torch.clamp_min(lam / 3.0, 1e-9), lam * 4.0)
    rel = (cost - new_cost) / torch.clamp_min(cost, 1e-30)
    done = (accept & (rel < 1e-9)) | (lam > 1e10)
    return prob, lam, torch.where(accept, new_cost, cost), done


def _scatter(idx, vals, shape):
    """zeros(shape) with vals (M, ...) added at rows idx (M,)."""
    return torch.zeros(shape, dtype=vals.dtype, device=vals.device).index_add_(0, idx, vals)


def dense_normal(prob: PgoProblem):
    """(r, H (D, D), g (D,)): JtJ and the gradient scattered edge by edge
    into the dense normal equations (``solver.py:148``)."""
    N = prob.p.shape[0]
    ib, ie = prob.edges_idx[:, 0], prob.edges_idx[:, 1]
    r, J_e, J_b = _edge_res_and_jacs(prob)
    J = torch.cat([J_e, J_b])  # (2M, 6|7, 7): end then begin of each edge
    g = _scatter(torch.cat([ie, ib]), torch.einsum("mij,mi->mj", J, torch.cat([r, r])), (N, 7))
    JJ = torch.einsum("mia,mib->mab", J, J)
    be = torch.einsum("mia,mib->mab", J_b, J_e)
    # the (N, N, 7, 7) blocks in row-major pairs: (i, i) diagonal, (ib, ie)
    # and its transpose (ie, ib) cross
    blocks = _scatter(torch.cat([torch.cat([ie, ib]) * (N + 1), ib * N + ie, ie * N + ib]),
                      torch.cat([JJ, be, be.transpose(1, 2)]), (N * N, 7, 7))
    H = blocks.reshape(N, N, 7, 7).permute(0, 2, 1, 3).reshape(N * 7, N * 7)
    return r, H, g.reshape(N * 7)


def pgo_solve_dense_jit(prob: PgoProblem, max_iters: int = 100):
    """LM with a dense normal-equation Cholesky per iteration
    (``solver.py:133``). Returns (prob, cost, iters)."""
    N = prob.p.shape[0]
    D = N * 7
    eye = torch.eye(D, dtype=prob.p.dtype, device=prob.p.device)

    def body(prob, lam, cost):
        _, H, g = dense_normal(prob)
        diag = torch.diagonal(H)
        # fixed dims have zero rows, columns and gradient: a unit diagonal
        # keeps the factorisation SPD and their step exactly 0
        damped = H + torch.diag(lam * torch.clamp(diag, 1e-6, 1e32) + (diag <= 0.0).to(H.dtype))
        L, info = torch.linalg.cholesky_ex(damped)
        ok = (info == 0) & torch.isfinite(L).all()
        Lsafe = torch.where(ok, L, eye)
        step = torch.cholesky_solve(g[:, None], Lsafe)[:, 0].reshape(N, 7) * prob.free_mask
        trial = _apply_step(prob, step)
        return _accept(prob, trial, lam, cost, _cost(trial), ok)

    return _lm_loop(prob, max_iters, body)


def pgo_solve_jit(prob: PgoProblem, max_iters: int = 100, cg_iters: int = 60):
    """LM whose normal equations are solved matrix-free by block-Jacobi
    preconditioned CG (``solver.py:227``). Returns (prob, cost, iters)."""
    N = prob.p.shape[0]
    ib, ie = prob.edges_idx[:, 0], prob.edges_idx[:, 1]

    def hvp(J_e, J_b, lam_diag, v):
        """(JtJ + lam*D) v over the edges, v: (N, 7)."""
        Jv = torch.einsum("mij,mj->mi", J_e, v[ie]) + torch.einsum("mij,mj->mi", J_b, v[ib])
        out = (_scatter(ie, torch.einsum("mij,mi->mj", J_e, Jv), v.shape)
               + _scatter(ib, torch.einsum("mij,mi->mj", J_b, Jv), v.shape))
        return out + lam_diag * v

    def cg(J_e, J_b, lam_diag, precond, g):
        x = torch.zeros_like(g)
        r = g
        z = torch.einsum("nij,nj->ni", precond, r)
        d = z
        rz = torch.sum(r * z)
        for _ in range(cg_iters):
            Hd = hvp(J_e, J_b, lam_diag, d)
            alpha = rz / torch.clamp_min(torch.sum(d * Hd), 1e-30)
            x = x + alpha * d
            r = r - alpha * Hd
            z = torch.einsum("nij,nj->ni", precond, r)
            rz_new = torch.sum(r * z)
            beta = rz_new / torch.clamp_min(rz, 1e-30)
            d = z + beta * d
            rz = rz_new
        return x

    def body(prob, lam, cost):
        r, J_e, J_b = _edge_res_and_jacs(prob)
        g = (_scatter(ie, torch.einsum("mij,mi->mj", J_e, r), (N, 7))
             + _scatter(ib, torch.einsum("mij,mi->mj", J_b, r), (N, 7)))
        blk = (_scatter(ie, torch.einsum("mia,mib->mab", J_e, J_e), (N, 7, 7))
               + _scatter(ib, torch.einsum("mia,mib->mab", J_b, J_b), (N, 7, 7)))
        diag = torch.clamp(torch.diagonal(blk, dim1=-2, dim2=-1), 1e-6, 1e32)
        lam_diag = lam * diag
        # block-Jacobi preconditioner: inv(blk + lam*diag + fixed-dim eye)
        fixed = 1.0 - prob.free_mask
        precond, _ = torch.linalg.inv_ex(blk + torch.diag_embed(lam_diag)
                                         + torch.diag_embed(fixed + 1e-8))
        step = cg(J_e, J_b, lam_diag, precond, g) * prob.free_mask
        trial = _apply_step(prob, step)
        return _accept(prob, trial, lam, cost, _cost(trial), torch.ones_like(lam, dtype=torch.bool))

    return _lm_loop(prob, max_iters, body)


def _rvec_covar_to_tqs_order(covar7, rvec):
    """Reorder an (rvec, tvec, s) covariance to (t, q-scaled-r, s) with the
    k = sin(theta/2)/theta quaternion scaling (``solver.py:320``)."""
    theta2 = float(np.dot(rvec, rvec))
    if theta2 > 0:
        theta = np.sqrt(theta2)
        k = np.sin(theta * 0.5) / theta
    else:
        k = 0.5
    out = np.empty((7, 7), np.float64)
    for i1 in range(7):
        for i2 in range(7):
            i1t = 6 if i1 == 6 else (i1 + 3 if i1 < 3 else i1 - 3)
            i2t = 6 if i2 == 6 else (i2 + 3 if i2 < 3 else i2 - 3)
            sc = 1.0
            if i1t < 3:
                sc *= k
            if i2t < 3:
                sc *= k
            out[i1, i2] = covar7[i1t, i2t] * sc
    return out


def build_problem(poses7, poses_idx, edges_idx, edges_pose, edges_covar, optimize_7dof: bool,
                  device) -> tuple[PgoProblem, np.ndarray, dict]:
    """Host-side assembly (``solver.py:361``): pose-id remap, edge covariance
    whitening in float64, dropping of edges with a non-finite covariance.
    Returns (problem on device, pose ids, {'n_poses', 'n_edges'})."""
    n = poses7.shape[0]
    ids = np.arange(n, dtype=np.int64) if poses_idx is None else np.asarray(poses_idx, np.int64)
    id_to_row = {int(pid): i for i, pid in enumerate(ids)}
    if len(id_to_row) != n:
        raise ValueError("Duplicate pose id")

    kept, sqrt_infos = [], []
    for m in range(edges_idx.shape[0]):
        covar = np.asarray(edges_covar[m], np.float64)
        if not np.all(np.isfinite(covar)):
            print("Warning: Nan/Inf encountered at PGO edge covar")
            continue
        covar_tqs = _rvec_covar_to_tqs_order(covar, np.asarray(edges_pose[m, :3], np.float64))
        info = np.linalg.inv(covar_tqs)
        # lower-triangular square root (llt().matrixL(), pgo.cpp:34-39)
        try:
            L = np.linalg.cholesky(info)
        except np.linalg.LinAlgError:
            info = 0.5 * (info + info.T) + 1e-12 * np.eye(7)
            L = np.linalg.cholesky(info)
        kept.append(m)
        sqrt_infos.append(L)

    M = len(kept)
    kept_np = np.asarray(kept, np.int64)
    q = lie.quat_from_rvec(torch.as_tensor(np.asarray(poses7[:, :3], np.float32))).numpy()
    e_idx = np.zeros((M, 2), np.int64)
    for j, m in enumerate(kept):
        e_idx[j] = id_to_row[int(edges_idx[m, 0])], id_to_row[int(edges_idx[m, 1])]
    meas = np.asarray(edges_pose, np.float32)[kept_np].reshape(M, 7)
    meas_q = lie.quat_from_rvec(torch.as_tensor(meas[:, :3])).numpy()
    sinfo = (np.stack(sqrt_infos).astype(np.float32) if kept
             else np.zeros((0, 7, 7), np.float32))

    free = np.ones((n, 7), np.float32)
    # first pose (lowest id) gauge-fixed entirely (pgo.cpp:70-74)
    free[id_to_row[int(ids.min())]] = 0.0
    if not optimize_7dof:
        free[:, 6] = 0.0  # scale blocks constant (pgo.cpp:56-59)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    prob = PgoProblem(
        p=t(poses7[:, 3:6]), q=t(q), s=t(poses7[:, 6]), edges_idx=t(e_idx, torch.int64),
        meas_p=t(meas[:, 3:6]), meas_q=t(meas_q), meas_s=t(meas[:, 6]), sqrt_info=t(sinfo),
        free_mask=t(free),
    )
    return prob, ids, {"n_poses": n, "n_edges": M}
