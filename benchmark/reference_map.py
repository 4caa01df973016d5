"""The plain reference of a mapped drive: numpy alone, float64.

Two parts, independent of the program:

* **Truth.** The drive is rendered from the seed (``scene.py``; the laps of
  ``drivers/drive.py``), so each frame's true pose is known here. VO's
  published motions are held to the true increments by
  ``reference.pose_errors``; the map's keyframe poses by ``map_errors``:
  after aligning the first keyframe with its true pose, the RMS of the
  keyframe positions' errors relative to the drive's extent, and the
  largest rotation error; each frame-alignment link's measured motion by
  ``link_errors``, against the true motion between its two keyframes.
* **PGO.** ``PoseGraph`` is a Levenberg-Marquardt of the pose graph that
  the program solved, written from its description: vertices (rvec, t,
  log s) of camera-to-world poses; an edge (begin b, end a) with its
  measured motion, whitened by the lower Cholesky factor L of the inverse
  of its 7x7 covariance taken to the (t, rotation, scale) order with the
  rotation rows scaled by sin(theta / 2) / theta of the measured rotation
  (a covariance that is not finite drops the edge); the residual, before
  L, is (R_a^T (p_b - p_a) / sqrt(s_a s_b) - t_meas, twice the vector part
  of the quaternion of R_meas (R_a^T R_b)^T, log s_a - log s_b - log
  s_meas) and the cost half the sum of |L res|^2; the lowest id's vertex
  is held, and the scale is held unless the graph is 7-DoF. Jacobians by
  central differences; the normal equations solved with every vertex whose
  edges reach only its two neighbours in id order (the frames between
  keyframes) eliminated exactly, block-tridiagonal run by run, and the
  rest dense.
"""

from __future__ import annotations

import numpy as np


# ----------------------------------------------------------------------
# rotations, batched
# ----------------------------------------------------------------------


def rodrigues_batch(rv: np.ndarray) -> np.ndarray:
    """(..., 3) rotation vectors -> (..., 3, 3) matrices."""
    rv = np.asarray(rv, np.float64)
    th = np.linalg.norm(rv, axis=-1)[..., None, None]
    k = rv / np.where(th[..., 0] > 0, th[..., 0], 1.0)
    K = np.zeros(rv.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    return np.eye(3) + np.sin(th) * K + (1.0 - np.cos(th)) * (K @ K)


def quat_of(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 4) unit quaternions [w, x, y, z] with w >= 0."""
    R = np.asarray(R, np.float64)
    w = 0.5 * np.sqrt(np.clip(1.0 + R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2], 0.0, None))
    # the vector part from the skew part (exact for small angles); near
    # a half turn from the diagonal, signed by the skew part
    v_small = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                        R[..., 1, 0] - R[..., 0, 1]], -1) / (4.0 * np.maximum(w, 0.1))[..., None]
    v_big = 0.5 * np.sqrt(np.clip(np.stack([
        1.0 + R[..., 0, 0] - R[..., 1, 1] - R[..., 2, 2],
        1.0 - R[..., 0, 0] + R[..., 1, 1] - R[..., 2, 2],
        1.0 - R[..., 0, 0] - R[..., 1, 1] + R[..., 2, 2]], -1), 0.0, None))
    v_big = np.copysign(v_big, v_small)
    v = np.where((w > 0.1)[..., None], v_small, v_big)
    q = np.concatenate([w[..., None], v], -1)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def angle_deg(R: np.ndarray) -> np.ndarray:
    """Rotation angles (deg) of (..., 3, 3) matrices."""
    c = (np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


# ----------------------------------------------------------------------
# the map against the truth
# ----------------------------------------------------------------------


def map_errors(Tcw: np.ndarray, Tcw_true: np.ndarray, extent: float) -> tuple[float, float]:
    """(ATE relative to ``extent``, largest rotation error in deg) of
    camera-to-world poses (N, 4, 4) after the first is aligned with its
    true pose."""
    Tcw = np.asarray(Tcw, np.float64)
    Tcw_true = np.asarray(Tcw_true, np.float64)
    A = Tcw_true[0] @ np.linalg.inv(Tcw[0])
    aligned = A @ Tcw
    d = aligned[:, :3, 3] - Tcw_true[:, :3, 3]
    if not np.all(np.isfinite(d)):
        return float("inf"), float("inf")
    ate = float(np.sqrt(np.mean(np.sum(d * d, axis=1)))) / extent
    rot = angle_deg(aligned[:, :3, :3] @ np.swapaxes(Tcw_true[:, :3, :3], -1, -2))
    return ate, float(rot.max())


def link_errors(Tc1c2: np.ndarray, Tc1c2_true: np.ndarray) -> tuple[float, float]:
    """(largest rotation error in deg, largest translation error in the
    scene's units) of measured motions (N, 4, 4) between two frames against
    the true ones."""
    Tc1c2 = np.asarray(Tc1c2, np.float64)
    Tc1c2_true = np.asarray(Tc1c2_true, np.float64)
    rot = angle_deg(Tc1c2[:, :3, :3] @ np.swapaxes(Tc1c2_true[:, :3, :3], -1, -2))
    t = np.linalg.norm(Tc1c2[:, :3, 3] - Tc1c2_true[:, :3, 3], axis=1)
    if not (np.all(np.isfinite(rot)) and np.all(np.isfinite(t))):
        return float("inf"), float("inf")
    return float(rot.max()), float(t.max())


# ----------------------------------------------------------------------
# the pose graph
# ----------------------------------------------------------------------


def sqrt_information(covar7: np.ndarray, rvec: np.ndarray) -> np.ndarray | None:
    """The lower Cholesky factor of the information of an (rvec, t, s)
    covariance taken to the residual's (t, rotation, scale) order, the
    rotation rows and columns scaled by sin(theta / 2) / theta; None when
    the covariance is not finite."""
    C = np.asarray(covar7, np.float64)
    if not np.all(np.isfinite(C)):
        return None
    th = float(np.linalg.norm(rvec))
    k = np.sin(0.5 * th) / th if th > 0 else 0.5
    order = [3, 4, 5, 0, 1, 2, 6]
    sc = np.array([1, 1, 1, k, k, k, 1.0])
    C = C[np.ix_(order, order)] * np.outer(sc, sc)
    info = np.linalg.inv(C)
    try:
        return np.linalg.cholesky(info)
    except np.linalg.LinAlgError:
        return np.linalg.cholesky(0.5 * (info + info.T) + 1e-12 * np.eye(7))


class PoseGraph:
    """A pose graph as the program was given it: poses (N, 7) [rvec, t,
    log s], their ids, edges (M, 2) of ids (begin, end), measured motions
    (M, 7) and covariances (M, 7, 7)."""

    def __init__(self, poses, poses_idx, edges_idx, edges_pose, edges_covar, optimize_7dof):
        poses = np.asarray(poses, np.float64)
        ids = np.asarray(poses_idx, np.int64)
        row = {int(i): r for r, i in enumerate(ids)}
        L, keep = [], []
        for m in range(len(edges_idx)):
            s = sqrt_information(edges_covar[m], np.asarray(edges_pose[m, :3], np.float64))
            if s is not None:
                L.append(s)
                keep.append(m)
        keep = np.asarray(keep, np.int64)
        e = np.asarray(edges_idx, np.int64)[keep]
        meas = np.asarray(edges_pose, np.float64)[keep]
        self.n = len(ids)
        self.b = np.array([row[int(i)] for i in e[:, 0]], np.int64)
        self.a = np.array([row[int(i)] for i in e[:, 1]], np.int64)
        self.L = np.stack(L) if L else np.zeros((0, 7, 7))
        self.meas_R = rodrigues_batch(meas[:, :3])
        self.meas_t, self.meas_s = meas[:, 3:6], meas[:, 6]
        self.free = np.ones((self.n, 7))
        self.free[int(np.argmin(ids))] = 0.0
        if not optimize_7dof:
            self.free[:, 6] = 0.0
        self.state0 = (poses[:, 3:6].copy(), rodrigues_batch(poses[:, :3]), poses[:, 6].copy())

    # -- residuals ------------------------------------------------------
    def _res(self, pa, Ra, sa, pb, Rb, sb):
        Rat = np.swapaxes(Ra, -1, -2)
        s_avg = np.sqrt(np.exp(sa + sb))
        p_ab = np.einsum("...ij,...j->...i", Rat, pb - pa) / s_avg[..., None]
        R_d = self.meas_R @ np.swapaxes(Rat @ Rb, -1, -2)
        res = np.concatenate([p_ab - self.meas_t, 2.0 * quat_of(R_d)[..., 1:],
                              ((sa - sb) - self.meas_s)[..., None]], -1)
        return np.einsum("mij,...mj->...mi", self.L, res)

    def residuals(self, state):
        p, R, s = state
        return self._res(p[self.a], R[self.a], s[self.a], p[self.b], R[self.b], s[self.b])

    def cost(self, state) -> float:
        r = self.residuals(state)
        return 0.5 * float(np.sum(r * r))

    @staticmethod
    def retract(p, R, s, d):
        """Tangent steps d (..., 7) [dp, dtheta, ds]: p + dp, exp(dtheta) R, s + ds."""
        return p + d[..., :3], rodrigues_batch(d[..., 3:6]) @ R, s + d[..., 6]

    def _jacobians(self, state, h=1e-6):
        """Central-difference Jacobians (M, 7, 7) of each edge's residual
        in its end vertex's and its begin vertex's tangent."""
        p, R, s = state
        ends = [(p[self.a], R[self.a], s[self.a]), (p[self.b], R[self.b], s[self.b])]
        M = len(self.a)
        J = [np.zeros((M, 7, 7)), np.zeros((M, 7, 7))]
        for side in (0, 1):
            for k in range(7):
                d = np.zeros((M, 7))
                d[:, k] = h
                out = []
                for sign in (1.0, -1.0):
                    moved = list(ends)
                    moved[side] = self.retract(*ends[side], sign * d)
                    out.append(self._res(*moved[0], *moved[1]))
                J[side][:, :, k] = (out[0] - out[1]) / (2 * h)
        return J[0] * self.free[self.a][:, None, :], J[1] * self.free[self.b][:, None, :]

    # -- the solve --------------------------------------------------------
    def _normal(self, state):
        r = self.residuals(state)
        Ja, Jb = self._jacobians(state)
        n = self.n
        D = np.zeros((n, 7, 7))
        g = np.zeros((n, 7))
        np.add.at(D, self.a, np.einsum("mki,mkj->mij", Ja, Ja))
        np.add.at(D, self.b, np.einsum("mki,mkj->mij", Jb, Jb))
        np.add.at(g, self.a, np.einsum("mki,mk->mi", Ja, r))
        np.add.at(g, self.b, np.einsum("mki,mk->mi", Jb, r))
        off = {}
        ab = np.einsum("mki,mkj->mij", Ja, Jb)
        for m, (i, j) in enumerate(zip(self.a.tolist(), self.b.tolist())):
            blk = ab[m] if i < j else ab[m].T
            key = (min(i, j), max(i, j))
            off[key] = off[key] + blk if key in off else blk.copy()
        return D, off, g

    def _solve_normal(self, D, off, g):
        """x with (D, off) x = g: the chain vertices (every edge to an id
        neighbour) eliminated run by run, the rest solved dense."""
        n = self.n
        nb = [set() for _ in range(n)]
        for i, j in off:
            nb[i].add(j)
            nb[j].add(i)
        chain = np.array([bool(nb[i]) and nb[i] <= {i - 1, i + 1} for i in range(n)])
        kept = [i for i in range(n) if not chain[i]]
        kpos = {v: k for k, v in enumerate(kept)}
        S = np.zeros((7 * len(kept), 7 * len(kept)))
        rhs = np.zeros(7 * len(kept))

        def blk(i, j):
            return off[(i, j)] if i < j else off[(j, i)].T

        for v in kept:
            k = kpos[v]
            S[7 * k:7 * k + 7, 7 * k:7 * k + 7] += D[v]
            rhs[7 * k:7 * k + 7] += g[v]
            for u in nb[v]:
                if not chain[u]:
                    S[7 * k:7 * k + 7, 7 * kpos[u]:7 * kpos[u] + 7] += blk(v, u)
        runs, i = [], 0
        while i < n:
            if chain[i]:
                j = i
                while j + 1 < n and chain[j + 1] and (j, j + 1) in off:
                    j += 1
                runs.append((i, j))
                i = j + 1
            else:
                i += 1
        solved = []
        for c0, c1 in runs:
            ends = [(u, c0) for u in nb[c0] if u == c0 - 1 and not chain[u]]
            ends += [(u, c1) for u in nb[c1] if u == c1 + 1 and not chain[u]]
            m = c1 - c0 + 1
            w = 1 + 7 * len(ends)
            R = np.zeros((m, 7, w))
            R[:, :, 0] = g[c0:c1 + 1]
            for e, (u, c) in enumerate(ends):
                R[c - c0, :, 1 + 7 * e:8 + 7 * e] = blk(c, u)
            X = _block_thomas(D[c0:c1 + 1], [blk(c, c + 1) for c in range(c0, c1)], R)
            for e, (u, c) in enumerate(ends):
                Bu = R[c - c0, :, 1 + 7 * e:8 + 7 * e]
                ku = kpos[u]
                rhs[7 * ku:7 * ku + 7] -= Bu.T @ X[c - c0, :, 0]
                for f, (u2, c2) in enumerate(ends):
                    k2 = kpos[u2]
                    S[7 * ku:7 * ku + 7, 7 * k2:7 * k2 + 7] -= Bu.T @ X[c - c0, :, 1 + 7 * f:8 + 7 * f]
            solved.append((c0, c1, ends, X))
        xk = np.linalg.solve(S, rhs) if len(kept) else np.zeros(0)
        x = np.zeros((n, 7))
        for v in kept:
            x[v] = xk[7 * kpos[v]:7 * kpos[v] + 7]
        for c0, c1, ends, X in solved:
            xc = X[:, :, 0].copy()
            for e, (u, _) in enumerate(ends):
                xc -= X[:, :, 1 + 7 * e:8 + 7 * e] @ x[u]
            x[c0:c1 + 1] = xc
        return x

    def solve(self, max_iters: int = 100):
        """Levenberg-Marquardt from the given poses. Returns (state, cost,
        iterations)."""
        state = self.state0
        cost = self.cost(state)
        lam = 1e-4
        it = 0
        for it in range(1, max_iters + 1):
            D, off, g = self._normal(state)
            diag = np.diagonal(D, axis1=-2, axis2=-1)
            damp = lam * np.clip(diag, 1e-6, None) + (diag <= 0)
            Dd = D + damp[..., None] * np.eye(7)
            step = self._solve_normal(Dd, off, g) * self.free
            trial = self.retract(*state, -step)
            new = self.cost(trial)
            if np.isfinite(new) and new < cost:
                rel = (cost - new) / max(cost, 1e-300)
                state, cost, lam = trial, new, max(lam / 3.0, 1e-12)
                if rel < 1e-12:
                    break
            else:
                lam *= 4.0
                if lam > 1e10:
                    break
        return state, cost, it

    def state_of(self, poses) -> tuple:
        """(p, R, s) of poses (N, 7) [rvec, t, log s] in this graph's rows."""
        poses = np.asarray(poses, np.float64)
        return poses[:, 3:6], rodrigues_batch(poses[:, :3]), poses[:, 6]


def _block_thomas(D, U, R):
    """X with A X = R for the block-tridiagonal A of diagonal blocks D (m,
    7, 7) and upper blocks U (m - 1 of (7, 7); the lower are their
    transposes); R (m, 7, w)."""
    m = len(D)
    Cp = [None] * m
    Rp = np.empty_like(R)
    Mk = D[0]
    for k in range(m):
        if k:
            Lk = U[k - 1].T
            Mk = D[k] - Lk @ Cp[k - 1]
            rk = R[k] - Lk @ Rp[k - 1]
        else:
            rk = R[0]
        if k < m - 1:
            sol = np.linalg.solve(Mk, np.concatenate([U[k], rk], 1))
            Cp[k], Rp[k] = sol[:, :7], sol[:, 7:]
        else:
            Rp[k] = np.linalg.solve(Mk, rk)
    X = np.empty_like(R)
    X[m - 1] = Rp[m - 1]
    for k in range(m - 2, -1, -1):
        X[k] = Rp[k] - Cp[k] @ X[k + 1]
    return X


# the least optimum cost a ratio is taken over, an edge: a graph whose
# edges agree (a chain) has an optimum of ~0, where the float32 program's
# rounding alone reads ~1e-9 an edge
COST_FLOOR = 1e-4


def pgo_check(call: dict, pick: np.ndarray, extent: float, optimize_7dof: bool,
              control: bool = False) -> dict:
    """The program's PGO against the plain LM on the same graph: ``call``
    holds the graph the program was given (``poses``, ``poses_idx``,
    ``edges_idx``, ``edges_pose``, ``edges_covar``) and what it returned
    (``out``); ``pick`` the rows whose poses are compared. Returns the
    program's cost over the plain solver's (both costs by ``cost``; the
    plain one no less than ``COST_FLOOR`` an edge) and
    the largest position gap over the picked rows relative to ``extent``.
    ``control`` puts stale answers in the program's place: each row gets
    the row before it."""
    g = PoseGraph(call["poses"], call["poses_idx"], call["edges_idx"], call["edges_pose"],
                  call["edges_covar"], optimize_7dof)
    out = np.asarray(call["out"], np.float64)
    if control:
        out = np.concatenate([out[:1], out[:-1]])
    prog = g.state_of(out)
    plain, plain_cost, iters = g.solve()
    gap = np.linalg.norm(prog[0][pick] - plain[0][pick], axis=1)
    floor = max(plain_cost, COST_FLOOR * len(g.a))
    # the plain optimum held in float16, the precision below the program's
    # float32: the least a float16 computation could read
    p16, R16, s16 = (np.asarray(x, np.float16).astype(np.float64) for x in plain)
    return {"pgo_cost_gap": g.cost(prog) / floor,
            "pgo_pose_gap": float(gap.max()) / extent if len(gap) else 0.0,
            "pgo_cost_gap_float16": g.cost((p16, R16, s16)) / floor,
            "pgo_edges": float(len(g.a)), "pgo_plain_iters": float(iters)}
