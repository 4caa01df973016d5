"""Levenberg-Marquardt solver for dense frame alignment
(port of ``voldor_tpu/falign/solver.py``).

The solve is batched over LANES: L independent problems of N frames each
that share one pair list (local frame indices) and one dim mask. ``falign()``
is one lane of N frames; ``falign_pairs()`` is P lanes of two frames with
the pairs (0, 1) and (1, 0). Lane l's frame j is row ``l * N + j`` of the
FrameMaps. The JAX package vmaps over pairs and runs a ``lax.while_loop``;
here the batch is an explicit axis and a chunk of LM iterations
(``lm_iterate``) advances the lanes that are live and not out of budget and
freezes the others: on the card one launch of the chunk kernel
(``ops/falign_kernels.py:lm_chunk``, a thread-block cluster a lane), on the
CPU a host loop of ``lm_body`` over the plain versions. The done flags are
read once per chunk (``solve_lanes``).

The Jacobian is taken w.r.t. BOTH frames of every pair (the analytic chain
rule of ``residual.pair_residual_and_grads``; forward mode through
``pair_residual_map`` is the test oracle) and all frames of a lane solve
jointly. Covariances are per-frame blocks of inv(JtJ) from the ref-side
Jacobians (``solver.py:367``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from voldor_tpu_torch.falign.residual import (FrameMaps, lane_pairs, pair_jacobians,
                                              pair_residual_map)
from voldor_tpu_torch.ops import falign_kernels as fk
from voldor_tpu_torch.utils import profiling


class LaneProblem(NamedTuple):
    """What every LM iteration of a batch of lanes reads."""

    maps: FrameMaps  # rows l * n_frames + j
    pairs: torch.Tensor  # (np, 2) int64, local frame indices
    oh_r: torch.Tensor  # (np, N) one-hot of each pair's ref frame
    oh_t: torch.Tensor  # (np, N) one-hot of each pair's tar frame
    n_frames: int
    intr: tuple  # (fx, fy, cx, cy) 0-d tensors
    vbf: torch.Tensor
    crw: torch.Tensor
    scalars: tuple  # (fx, fy, cx, cy, vbf, crw) as Python floats, for the kernels
    use_photo: bool
    dim_mask: torch.Tensor  # (N, 9)
    gauge_U: torch.Tensor  # (K, N * 9) scale-gauge indicator rows


class PairLmState(NamedTuple):
    """Per-lane LM state (``solver.py:46``). H/g are the raw normal
    equations AT params (no gauge, no damping): the body linearizes at the
    trial point only and reuses the carried system on rejects."""

    params: torch.Tensor  # (L, N, 9)
    lam: torch.Tensor  # (L,) LM damping
    cost: torch.Tensor  # (L,) raw cost at params on the current phase grid
    H: torch.Tensor  # (L, D, D)
    g: torch.Tensor  # (L, D)
    it: torch.Tensor  # (L,) int32 iterations done in the current phase
    done: torch.Tensor  # (L,) bool
    w2: torch.Tensor  # (L,) gauge weight (0 = derive from the next Hessian)


def _pair_res_and_jacs(prob: LaneProblem, params, lanes, stride: int):
    """Residuals (L, np, m) and Jacobians w.r.t. ref and tar parameters
    ((L, np, m, 9) each), columns masked by the dim mask (``solver.py:67``).
    The per-pixel oracle of the linearise kernel's blocks; test use."""
    return pair_jacobians(params, lanes, prob.pairs, prob.dim_mask, prob.maps, *prob.intr,
                          prob.vbf, prob.crw, prob.use_photo, stride)


def _pair_res_and_jacs_ad(prob: LaneProblem, params, lanes, stride: int):
    """Forward-mode oracle for _pair_res_and_jacs (``solver.py:93``): the
    Jacobian of pair_residual_map over each pair's 18 parameters by
    ``torch.func.jacfwd``, one pair at a time. Test use only."""
    L, n_p = params.shape[0], prob.pairs.shape[0]
    pr, pt, ref, tar = lane_pairs(params, lanes, prob.pairs)
    out_r, out_jr, out_jt = [], [], []
    for b in range(ref.shape[0]):
        def f18(p18, b=b):
            r, _ = pair_residual_map(p18[None, :9], p18[None, 9:], ref[b:b + 1], tar[b:b + 1],
                                     prob.maps, *prob.intr, prob.vbf, prob.crw, prob.use_photo,
                                     stride)
            return r[0]

        p18 = torch.cat([pr[b], pt[b]])
        J = torch.func.jacfwd(f18)(p18)  # (hs, ws, 18)
        out_r.append(f18(p18))
        out_jr.append(J[..., :9])
        out_jt.append(J[..., 9:])
    m = out_r[0].numel()
    res = torch.stack(out_r).reshape(L, n_p, m)
    mask_r = prob.dim_mask[prob.pairs[:, 0]][None, :, None, :]
    mask_t = prob.dim_mask[prob.pairs[:, 1]][None, :, None, :]
    return (res, torch.stack(out_jr).reshape(L, n_p, m, 9) * mask_r,
            torch.stack(out_jt).reshape(L, n_p, m, 9) * mask_t)


def _joint_normal_eq(res, Jr, Jt, oh_r, oh_t):
    """Per lane, the full (N*9, N*9) JtJ and (N*9,) gradient from the
    per-pair Jacobians (``solver.py:237``); oh_r / oh_t (np, N) one-hot
    the pairs' frames. The per-pixel oracle of the LM path's normal
    equations; test use."""
    L, n_frames = res.shape[0], oh_r.shape[1]
    Hrr = torch.einsum("lpki,lpkj->lpij", Jr, Jr)
    Hrt = torch.einsum("lpki,lpkj->lpij", Jr, Jt)
    Htt = torch.einsum("lpki,lpkj->lpij", Jt, Jt)
    H = (torch.einsum("pa,pb,lpij->laibj", oh_r, oh_r, Hrr)
         + torch.einsum("pa,pb,lpij->laibj", oh_r, oh_t, Hrt)
         + torch.einsum("pa,pb,lpji->laibj", oh_t, oh_r, Hrt)
         + torch.einsum("pa,pb,lpij->laibj", oh_t, oh_t, Htt))
    g = (torch.einsum("pa,lpki,lpk->lai", oh_r, Jr, res)
         + torch.einsum("pa,lpki,lpk->lai", oh_t, Jt, res))
    D = n_frames * 9
    return H.reshape(L, D, D), g.reshape(L, D)


def linearize(prob: LaneProblem, params, lanes, stride: int):
    """(cost, H, g) per lane at params: one residual + Jacobian sweep, its
    per-pair blocks assembled per lane."""
    return fk.assemble(fk.linearize(prob, params, lanes, stride), prob.oh_r, prob.oh_t)


def lm_body(prob: LaneProblem, st: PairLmState, lanes, stride: int, it_end=None) -> PairLmState:
    """One damped-LM iteration (``solver.py:184``) of every lane whose
    it < it_end (default: one more) and that is not done: solve the damped,
    gauge-regularised carried system, linearize at the trial point, accept
    or reject, adapt the damping by the gain ratio and test the stopping
    rules. The other lanes keep their state. On the card: the chunk kernel
    of ops/falign_kernels.py with n = 1, one launch and no host read."""
    if it_end is None:
        it_end = st.it + 1
    return fk.lm_iteration(prob, st, lanes, stride, it_end)


def lm_iterate(prob: LaneProblem, st: PairLmState, lanes, stride: int, n_iters: int) -> PairLmState:
    """Up to n_iters LM iterations per lane with no host read: a lane runs
    while it < (its it at entry) + n_iters and it is not done; the others
    keep their state (the vmapped ``lax.while_loop`` of ``solver.py:424-441``).
    On the card one launch of the chunk kernel; on the CPU a loop of
    lm_body."""
    if st.params.device.type != "cpu":
        return fk.lm_chunk(prob, st, lanes, stride, n_iters)
    it_end = st.it + n_iters
    for _ in range(n_iters):
        st = lm_body(prob, st, lanes, stride, it_end)
    return st


def phase_init(prob: LaneProblem, params, lanes, stride: int) -> PairLmState:
    """A new phase on the stride grid: one linearize at params fills
    (cost, H, g); lam, it, done and w2 reset (``solver.py:452``)."""
    cost, H, g = linearize(prob, params, lanes, stride)
    L = params.shape[0]
    dev = params.device
    return PairLmState(
        params=params, lam=torch.full((L,), 1e-3, dtype=params.dtype, device=dev), cost=cost,
        H=H, g=g, it=torch.zeros(L, dtype=torch.int32, device=dev),
        done=torch.zeros(L, dtype=torch.bool, device=dev),
        w2=torch.zeros(L, dtype=params.dtype, device=dev),
    )


def _take(st: PairLmState, idx) -> PairLmState:
    return PairLmState(*(a[idx] for a in st))


def _put(st: PairLmState, idx, sub: PairLmState) -> PairLmState:
    out = []
    for a, b in zip(st, sub):
        a = a.clone()
        a[idx] = b
        out.append(a)
    return PairLmState(*out)


def solve_lanes(prob: LaneProblem, params0, phases):
    """The LM over every lane, phase by phase, with per-lane convergence
    compaction (``api.py:171``): each phase (stride, budget, chunk) runs in
    chunks of at most ``chunk`` iterations over the lanes still live; after
    each chunk ONE device-to-host read of the packed [done, it] flags drops
    the converged lanes. Per-lane results do not depend on the grouping.

    Returns (params (L, N, 9), final cost (L,), per-phase iteration counts:
    a list of (L,) int arrays)."""
    L = params0.shape[0]
    dev = params0.device
    all_lanes = torch.arange(L, device=dev)
    params = params0
    cost = None
    phase_iters = []
    for stride, budget, chunk in phases:
        with profiling.span("falign.setup"):
            st = phase_init(prob, params, all_lanes, stride)
        it_host = np.zeros(L, np.int32)
        live = np.arange(L)
        used = 0
        while live.size and used < budget:
            n = min(chunk, budget - used)
            profiling.count("falign_chunks")
            with profiling.span("falign.lm"):
                if live.size == L:
                    st = lm_iterate(prob, st, all_lanes, stride, n)
                    done_it = torch.stack([st.done.to(torch.int32), st.it])
                else:
                    idx = torch.as_tensor(live, device=dev)
                    sub = lm_iterate(prob, _take(st, idx), idx, stride, n)
                    st = _put(st, idx, sub)
                    done_it = torch.stack([sub.done.to(torch.int32), sub.it])
                # the one read per chunk
                flags = profiling.host_read("falign.flags", lambda t: t.cpu().numpy(), done_it)
            it_host[live] = flags[1]
            used += n
            live = live[flags[0] == 0]
        params, cost = st.params, st.cost
        phase_iters.append(it_host)
    return params, cost, phase_iters


def pair_covariances(prob: LaneProblem, params, lanes, stride: int):
    """Per-frame covariance blocks at the optimum from the ref-side
    Jacobians (``solver.py:367``): JrT Jr is the linearisation's Hrr block.
    Returns (covars (L, N, 9, 9), zeros where unreliable; ok (L, N))."""
    L, N, n_p = params.shape[0], prob.n_frames, prob.pairs.shape[0]
    JtJ_p = fk.linearize(prob, params, lanes, stride).Hrr.reshape(L, n_p, 9, 9)
    JtJ = torch.einsum("pn,lpij->lnij", prob.oh_r, JtJ_p)
    JtJ_solve = JtJ + torch.diag_embed(1.0 - prob.dim_mask)
    Lc, info = torch.linalg.cholesky_ex(JtJ_solve)
    ok = (info == 0) & torch.isfinite(Lc).all(dim=(-2, -1))
    eye = torch.eye(9, dtype=params.dtype, device=params.device).expand(L, N, 9, 9)
    Lsafe = torch.where(ok[..., None, None], Lc, eye)
    covars = torch.cholesky_solve(eye, Lsafe)
    return torch.where(ok[..., None, None], covars, 0.0), ok


def align_scores(prob: LaneProblem, params, lanes, bound: float, stride: int):
    """Per pair (visibility, consistency) over the unweighted residual at
    the problem's stride (``solver.py:510``), from the linearise kernel's
    scores mode. Returns two (L, np) tensors."""
    L, n_p = params.shape[0], prob.pairs.shape[0]
    hs, ws = fk.grid_size(*prob.maps.bounds, stride)
    n_vis, cons = fk.score_sums(prob, params, lanes, stride, bound)
    consistency = cons / torch.clamp_min(n_vis, 1)
    visibility = n_vis / (hs * ws)
    return visibility.reshape(L, n_p), consistency.reshape(L, n_p)
