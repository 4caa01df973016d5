"""Frame alignment's LM iteration on hand-written CUDA kernels
(``csrc/falign_linearize.cu``, ``csrc/falign_lm.cu``): their wrappers,
their launch counts and the LM kernels' plain versions.

The JAX package runs a chunk of LM iterations of every lane inside one
device program (``voldor_tpu/falign/solver.py:396`` ``lm_chunk_pairs``: a
vmapped ``lax.while_loop`` over ``_make_lm_step``'s body, :184-235, whose
residual, analytic Jacobian and ``_joint_normal_eq`` XLA fuses). Here one
batched iteration is three launches:

* ``lm_propose`` — per lane: the gauge weight, the damped carried system,
  its Cholesky factor (identity where it fails), two triangular solves, the
  masked step and the trial parameters; lanes that are done or out of
  budget (``it >= it_end``) are marked inactive and keep their state;
* ``linearize_partials`` — per pair evaluation and tile of the strided ref
  grid, the residual, its analytic 18-column gradient and their Gram
  reductions (see PairBlocks), summed over the tile's pixels in a fixed
  order into a scratch tensor (no float atomics: two launches on the same
  inputs are bitwise equal); inactive lanes' pairs are skipped;
* ``lm_accept`` — per lane: the tiles' partial sums added in a fixed order,
  the lane's normal equations assembled from its pairs' blocks, the accept
  or reject of the trial, the gain-ratio damping, the stopping rules and
  the next state (frozen lanes copied through).

``linearize`` (the partials reduced per pair, a fourth kernel:
``reduce_partials``) and ``score_sums`` (the linearise kernel's scores mode)
serve the phase start, the covariances and the scores.

For CPU tensors every wrapper calls the plain version
(``falign.residual.pair_normal_blocks`` / ``pair_score_sums``,
``lm_propose_reference``, ``lm_accept_reference``); for CUDA tensors it
launches its kernel or raises. The wrappers take the solver's LaneProblem
and PairLmState (``falign/solver.py``) and return a state of the type they
were given.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from voldor_tpu_torch.falign.residual import PairBlocks, pair_normal_blocks, pair_score_sums
from voldor_tpu_torch.ops import _build

# Launches since the last reset (plain ints; chip_smoke.py reads them to
# show that the main path went through the kernels).
linearize_launches = 0  # falign_linearize_kernel, both modes
reduce_launches = 0  # falign_reduce_kernel
lm_propose_launches = 0
lm_accept_launches = 0

TILE = 256  # pixels of the strided grid per block of the linearise kernel
N_GRAM = 190  # the upper triangle of the 19 x 19 Gram matrix of [r, Jr, Jt]
N_SCORES = 2  # [visible pixels, sum of 1 - min(r^2, bound) / bound]
N_INFO = 8  # a proposal's per-lane scalars, in this order:
INFO = ("w2", "pred", "cur_cost", "step_inf", "ok", "active")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LIN_ARGTYPES = ([_P, _P, _I, _I, _I, _P, _P, _P, _P, _P] + [_I] * 6 + [_F] * 7
                 + [_P, _I, _P])
_RED_ARGTYPES = [_P, _P, _I, _I, _I, _P]
_PROPOSE_ARGTYPES = [_P] * 8 + [_P, _P, _I, _P, _I, _I, _P, _P, _P, _P]
_ACCEPT_ARGTYPES = [_P] * 8 + [_P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _I] + [_P] * 8 + [_P]


class Proposal(NamedTuple):
    """What lm_propose hands the linearise and accept steps."""

    trial: torch.Tensor  # (L, N, 9) trial parameters (the current ones where inactive)
    info: torch.Tensor  # (L, N_INFO) float: INFO's scalars, ok and active as 0 / 1
    active: torch.Tensor  # (L,) int32: the lane runs this iteration


def grid_size(h: int, w: int, stride: int) -> tuple[int, int]:
    """(rows, cols) of the strided ref grid (``arange(0, h, stride)``)."""
    return -(-h // stride), -(-w // stride)


def n_tiles(h: int, w: int, stride: int) -> int:
    hs, ws = grid_size(h, w, stride)
    return -(-(hs * ws) // TILE)


_gram_index: dict = {}


def _gram_idx(device) -> torch.Tensor:
    """(19, 19) int64 on device: the packed index of Gram entry (a, b),
    rows a <= b packed row-major, symmetric. Built on the device once per
    device (no host-to-device copy)."""
    key = str(device)
    if key not in _gram_index:
        r, c = torch.triu_indices(19, 19, device=device)
        k = torch.arange(N_GRAM, device=device)
        idx = torch.empty((19, 19), dtype=torch.int64, device=device)
        idx[r, c] = k
        idx[c, r] = k
        _gram_index[key] = idx
    return _gram_index[key]


def unpack_blocks(packed: torch.Tensor) -> PairBlocks:
    """(B, 190) packed Gram sums -> PairBlocks."""
    G = packed[:, _gram_idx(packed.device)]
    return PairBlocks(cost=0.5 * G[:, 0, 0], Hrr=G[:, 1:10, 1:10], Hrt=G[:, 1:10, 10:],
                      Htt=G[:, 10:, 10:], gr=G[:, 0, 1:10], gt=G[:, 0, 10:])


def assemble(blocks: PairBlocks, oh_r, oh_t):
    """Per lane, the (N*9, N*9) JtJ, the (N*9,) gradient and the cost from
    its pairs' blocks (``solver.py:237``); oh_r / oh_t (np, N) one-hot the
    pairs' frames. Returns (cost (L,), H (L, D, D), g (L, D))."""
    n_p, n_frames = oh_r.shape
    L = blocks.cost.shape[0] // n_p
    D = n_frames * 9
    Hrr, Hrt, Htt = (a.reshape(L, n_p, 9, 9) for a in (blocks.Hrr, blocks.Hrt, blocks.Htt))
    H = (torch.einsum("pa,pb,lpij->laibj", oh_r, oh_r, Hrr)
         + torch.einsum("pa,pb,lpij->laibj", oh_r, oh_t, Hrt)
         + torch.einsum("pa,pb,lpji->laibj", oh_t, oh_r, Hrt)
         + torch.einsum("pa,pb,lpij->laibj", oh_t, oh_t, Htt))
    g = (torch.einsum("pa,lpi->lai", oh_r, blocks.gr.reshape(L, n_p, 9))
         + torch.einsum("pa,lpi->lai", oh_t, blocks.gt.reshape(L, n_p, 9)))
    cost = torch.sum(blocks.cost.reshape(L, n_p), dim=1)
    return cost, H.reshape(L, D, D).contiguous(), g.reshape(L, D).contiguous()


# --------------------------------------------------------------------------
# checks and launches
# --------------------------------------------------------------------------


def _check(t: torch.Tensor, what: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")


def _cuda_device(t: torch.Tensor, what: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _check_problem(prob, params, lanes, dev):
    """Dtypes, shapes and contiguity of what the linearise kernel reads. The
    values of lanes and pairs are not read back (that would sync): lanes
    must index rows l * N of the maps and pairs local frames < N."""
    F, h, w, _ = prob.maps.packed.shape
    L, N = params.shape[0], prob.n_frames
    _check(prob.maps.packed, "maps.packed", torch.float32, (F, h, w, 5), dev)
    _check(prob.maps.weights, "maps.weights", torch.float32, (F, h, w), dev)
    _check(params, "params", torch.float32, (L, N, 9), dev)
    _check(lanes, "lanes", torch.int64, (L,), dev)
    _check(prob.pairs, "pairs", torch.int64, (prob.pairs.shape[0], 2), dev)
    _check(prob.dim_mask, "dim_mask", torch.float32, (N, 9), dev)
    if h < 2 or w < 2:
        raise ValueError(f"falign kernels take maps of at least 2 x 2, got {h} x {w}")


def linearize_partials(prob, params, lanes, stride: int, active=None, scores: bool = False,
                       bound: float = 1.0) -> torch.Tensor:
    """One launch of the linearise kernel (CUDA tensors only): per pair
    evaluation b = l * np + p and tile t of the strided grid, the tile's
    Gram sums (B, T, 190), or with ``scores`` the scores-mode sums
    (B, T, 2). ``active`` (L,) int32: the pairs of a lane whose flag is 0
    are skipped (their rows are left unwritten)."""
    dev = _cuda_device(params, "falign_linearize")
    _check_problem(prob, params, lanes, dev)
    F, h, w, _ = prob.maps.packed.shape
    L, N, n_p = params.shape[0], prob.n_frames, prob.pairs.shape[0]
    if active is not None:
        _check(active, "active", torch.int32, (L,), dev)
    T = n_tiles(h, w, stride)
    width = N_SCORES if scores else N_GRAM
    out = torch.empty((L * n_p, T, width), dtype=torch.float32, device=dev)
    fx, fy, cx, cy, vbf, crw = prob.scalars
    global linearize_launches
    fn = _build.function("falign_linearize_launch", _LIN_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(prob.maps.packed.data_ptr(), prob.maps.weights.data_ptr(), F, h, w,
                 params.data_ptr(), lanes.data_ptr(), prob.pairs.data_ptr(),
                 prob.dim_mask.data_ptr(), None if active is None else active.data_ptr(),
                 L, N, n_p, int(stride), int(bool(prob.use_photo)), int(scores),
                 fx, fy, cx, cy, vbf, crw, float(bound), out.data_ptr(), T, _stream(dev))
    _raise_on(err, "falign_linearize")
    linearize_launches += 1
    return out


def reduce_partials(part: torch.Tensor) -> torch.Tensor:
    """(B, T, W) partial sums -> (B, W), the tiles added in order. CPU
    tensors: torch.sum over the tiles; CUDA tensors: one launch of the
    reduce kernel."""
    if part.device.type == "cpu":
        return torch.sum(part, dim=1)
    dev = _cuda_device(part, "falign_reduce")
    if part.dim() != 3:
        raise ValueError(f"falign_reduce takes (B, T, W) partials, got {tuple(part.shape)}")
    _check(part, "partials", torch.float32, part.shape, dev)
    B, T, W = part.shape
    out = torch.empty((B, W), dtype=torch.float32, device=dev)
    global reduce_launches
    fn = _build.function("falign_reduce_launch", _RED_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(part.data_ptr(), out.data_ptr(), B, T, W, _stream(dev))
    _raise_on(err, "falign_reduce")
    reduce_launches += 1
    return out


def linearize(prob, params, lanes, stride: int) -> PairBlocks:
    """Per pair evaluation of the lanes, the linearisation's blocks at
    params (PairBlocks, B = L * np): the plain version on the CPU; on the
    card the linearise and reduce kernels."""
    if params.device.type == "cpu":
        return pair_normal_blocks(params, lanes, prob.pairs, prob.dim_mask, prob.maps, *prob.intr,
                                  prob.vbf, prob.crw, prob.use_photo, stride)
    return unpack_blocks(reduce_partials(linearize_partials(prob, params, lanes, stride)))


def score_sums(prob, params, lanes, stride: int, bound: float):
    """Per pair evaluation, the visible pixels of the unweighted residual
    and the sum over them of 1 - min(r^2, bound) / bound: two (B,) float
    tensors. The plain version on the CPU; on the card the linearise
    kernel's scores mode and the reduce kernel."""
    if params.device.type == "cpu":
        return pair_score_sums(params, lanes, prob.pairs, prob.maps, *prob.intr, prob.vbf,
                               prob.crw, prob.use_photo, stride,
                               torch.tensor(float(bound), dtype=params.dtype))
    s = reduce_partials(linearize_partials(prob, params, lanes, stride, scores=True,
                                           bound=bound))
    return s[:, 0], s[:, 1]


# --------------------------------------------------------------------------
# the LM step: plain versions
# --------------------------------------------------------------------------


def _gauge_sums(params, U):
    return params.reshape(params.shape[0], -1) @ U.T


def lm_propose_reference(prob, st, it_end) -> Proposal:
    """The propose kernel's plain version: the damped, gauge-regularised
    solve of every lane's carried system (``solver.py:184-200``), and the
    lane's activity: it < it_end and not done."""
    U = prob.gauge_U
    L, N = st.params.shape[0], prob.n_frames
    D = N * 9
    inactive = (1.0 - prob.dim_mask).reshape(-1)
    n_scale = torch.clamp_min(torch.sum(U), 1.0)
    u_any = torch.sum(U, dim=0)
    params, lam, cost, H, g = st.params, st.lam, st.cost, st.H, st.g
    w2 = torch.where(st.w2 > 0, st.w2,
                     torch.sum(torch.diagonal(H, dim1=-2, dim2=-1) * u_any, dim=-1) / n_scale)
    s_sums = _gauge_sums(params, U)
    Hg = H + w2[:, None, None] * (U.T @ U)
    gg = g + w2[:, None] * (s_sums @ U)
    diag = torch.clamp_min(torch.diagonal(Hg, dim1=-2, dim2=-1), 1e-8)
    damped = Hg + torch.diag_embed(lam[:, None] * diag + inactive)

    Lc, info = torch.linalg.cholesky_ex(damped)
    ok = (info == 0) & torch.isfinite(Lc).all(dim=(-2, -1))
    eye = torch.eye(D, dtype=Lc.dtype, device=Lc.device).expand(L, D, D)
    Lsafe = torch.where(ok[:, None, None], Lc, eye)
    # two triangular solves: a batched cholesky_solve syncs with the host on
    # a card (tools/profile_torch_mapping.py)
    half = torch.linalg.solve_triangular(Lsafe, gg[..., None], upper=False)
    step = torch.linalg.solve_triangular(Lsafe.transpose(-1, -2), half, upper=True)[..., 0]
    step_m = step.reshape(L, N, 9) * prob.dim_mask
    trial = params - step_m
    cur_cost = cost + 0.5 * w2 * torch.sum(s_sums * s_sums, dim=-1)
    sm = step_m.reshape(L, D)
    pred = 0.5 * (torch.sum(sm * (lam[:, None] * diag * sm), dim=-1) + torch.sum(sm * gg, dim=-1))
    step_inf = torch.amax(torch.abs(step_m), dim=(1, 2))
    active = (st.it < it_end) & ~st.done
    zeros = torch.zeros_like(w2)
    info = torch.stack([w2, pred, cur_cost, step_inf, ok.to(w2.dtype), active.to(w2.dtype),
                        zeros, zeros], dim=1)
    return Proposal(trial=trial, info=info, active=active.to(torch.int32))


def lm_accept_reference(prob, st, prop: Proposal, blocks: PairBlocks):
    """The accept kernel's plain version: the trial's normal equations from
    its pairs' blocks, then ``accept_lanes``."""
    return accept_lanes(prob, st, prop, *assemble(blocks, prob.oh_r, prob.oh_t))


def accept_lanes(prob, st, prop: Proposal, trial_cost, H_t, g_t):
    """Given the trial's per-lane (cost, H, g): the accept decision, the
    gain-ratio (Nielsen) damping (a reject multiplies by 4) and the stopping
    rules (``solver.py:200-235``); lanes that were not active keep their
    state (``solver.py:424-441``)."""
    U = prob.gauge_U
    w2, pred, cur_cost, step_inf, ok, active = prop.info[:, :6].unbind(1)
    ok, active = ok > 0, active > 0
    trial = prop.trial
    t_sums = _gauge_sums(trial, U)
    new_cost = trial_cost + 0.5 * w2 * torch.sum(t_sums * t_sums, dim=-1)
    accept = ok & torch.isfinite(new_cost) & (new_cost < cur_cost)
    rho = (cur_cost - new_cost) / torch.clamp_min(pred, 1e-30)
    dec = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0, 1.0)
    lam = torch.where(accept, torch.clamp_min(st.lam * dec, 1e-7), st.lam * 4.0)
    rel_drop = (cur_cost - new_cost) / torch.clamp_min(cur_cost, 1e-30)
    # stopping: cost plateau, a negligible step on accept or reject, or a
    # damping blow-up (solver.py:214-227)
    done = ((accept & (rel_drop < 1e-5)) | (accept & (step_inf < 1e-4))
            | ((~accept) & (step_inf < 3e-5)) | (lam > 1e6))
    a3 = accept[:, None, None]
    new = type(st)(
        params=torch.where(a3, trial, st.params), lam=lam,
        cost=torch.where(accept, trial_cost, st.cost),
        H=torch.where(a3, H_t, st.H), g=torch.where(accept[:, None], g_t, st.g),
        it=st.it + 1, done=done, w2=w2,
    )
    return type(st)(*(torch.where(active.reshape((-1,) + (1,) * (a.dim() - 1)), b, a)
                      for a, b in zip(st, new)))


# --------------------------------------------------------------------------
# the LM step: the kernels
# --------------------------------------------------------------------------

_smem_limit: dict = {}


def lm_smem_bytes(n_frames: int, n_gauge: int) -> int:
    """Dynamic shared memory of the larger of the two LM kernels for a lane
    of n_frames frames and n_gauge gauge rows (csrc/falign_lm.cu)."""
    D = 9 * n_frames
    return 4 * max(D * D + 3 * D + n_gauge, D * D + D + N_GRAM)


def _check_lm_fits(dev, n_frames: int, n_gauge: int):
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _smem_limit:
        out = ctypes.c_int(0)
        _raise_on(_build.function("falign_lm_smem_limit", [_I, ctypes.POINTER(_I)])(
            key, ctypes.byref(out)), "falign_lm_smem_limit")
        _smem_limit[key] = out.value
    need = lm_smem_bytes(n_frames, n_gauge)
    if need > _smem_limit[key]:
        raise RuntimeError(
            f"falign LM kernels: a lane of {n_frames} frames ({9 * n_frames} parameters) needs "
            f"{need} bytes of shared memory per block; this device allows {_smem_limit[key]}")


def _check_state(st, L, D, dev):
    N = D // 9
    _check(st.params, "state.params", torch.float32, (L, N, 9), dev)
    for name in ("lam", "cost", "w2"):
        _check(getattr(st, name), f"state.{name}", torch.float32, (L,), dev)
    _check(st.H, "state.H", torch.float32, (L, D, D), dev)
    _check(st.g, "state.g", torch.float32, (L, D), dev)
    _check(st.it, "state.it", torch.int32, (L,), dev)
    _check(st.done, "state.done", torch.bool, (L,), dev)


def _state_ptrs(st):
    return [t.data_ptr() for t in (st.params, st.lam, st.cost, st.H, st.g, st.it, st.done, st.w2)]


def lm_propose(prob, st, it_end) -> Proposal:
    """The propose step of every lane: the plain version on the CPU, one
    launch of the propose kernel on the card."""
    if st.params.device.type == "cpu":
        return lm_propose_reference(prob, st, it_end)
    dev = _cuda_device(st.params, "falign_lm_propose")
    L, N = st.params.shape[0], prob.n_frames
    D = 9 * N
    U = prob.gauge_U
    _check_state(st, L, D, dev)
    _check(it_end, "it_end", torch.int32, (L,), dev)
    _check(U, "gauge_U", torch.float32, (U.shape[0], D), dev)
    _check(prob.dim_mask, "dim_mask", torch.float32, (N, 9), dev)
    _check_lm_fits(dev, N, U.shape[0])
    trial = torch.empty_like(st.params)
    info = torch.empty((L, N_INFO), dtype=torch.float32, device=dev)
    active = torch.empty((L,), dtype=torch.int32, device=dev)
    global lm_propose_launches
    fn = _build.function("falign_lm_propose_launch", _PROPOSE_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(*_state_ptrs(st), it_end.data_ptr(), U.data_ptr(), U.shape[0],
                 prob.dim_mask.data_ptr(), L, N, trial.data_ptr(), info.data_ptr(),
                 active.data_ptr(), _stream(dev))
    _raise_on(err, "falign_lm_propose")
    lm_propose_launches += 1
    return Proposal(trial=trial, info=info, active=active)


def lm_accept(prob, st, prop: Proposal, lin):
    """The accept step of every lane: the plain version on the CPU (lin:
    the trial's PairBlocks); on the card (lin: the linearise kernel's
    (L * np, T, 190) partials) one launch of the accept kernel, which
    writes the next state into new tensors."""
    if st.params.device.type == "cpu":
        return lm_accept_reference(prob, st, prop, lin)
    dev = _cuda_device(st.params, "falign_lm_accept")
    L, N, n_p = st.params.shape[0], prob.n_frames, prob.pairs.shape[0]
    D = 9 * N
    U = prob.gauge_U
    _check_state(st, L, D, dev)
    _check(prop.trial, "trial", torch.float32, (L, N, 9), dev)
    _check(prop.info, "info", torch.float32, (L, N_INFO), dev)
    _check(prop.active, "active", torch.int32, (L,), dev)
    if lin.dim() != 3:
        raise ValueError(f"falign_lm_accept takes (B, T, 190) partials, got {tuple(lin.shape)}")
    _check(lin, "partials", torch.float32, (L * n_p, lin.shape[1], N_GRAM), dev)
    _check(prob.pairs, "pairs", torch.int64, (n_p, 2), dev)
    _check(U, "gauge_U", torch.float32, (U.shape[0], D), dev)
    _check_lm_fits(dev, N, U.shape[0])
    out = type(st)(*(torch.empty_like(a) for a in st))
    global lm_accept_launches
    fn = _build.function("falign_lm_accept_launch", _ACCEPT_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(*_state_ptrs(st), prop.trial.data_ptr(), prop.info.data_ptr(),
                 prop.active.data_ptr(), lin.data_ptr(), lin.shape[1], prob.pairs.data_ptr(),
                 n_p, U.data_ptr(), U.shape[0], L, N, *_state_ptrs(out), _stream(dev))
    _raise_on(err, "falign_lm_accept")
    lm_accept_launches += 1
    return out


def lm_iteration(prob, st, lanes, stride: int, it_end):
    """One damped-LM iteration of every lane whose it < it_end and that is
    not done; the others keep their state. CPU: the three plain versions;
    the card: propose, linearise and accept, three launches and no host
    read."""
    prop = lm_propose(prob, st, it_end)
    if st.params.device.type == "cpu":
        lin = linearize(prob, prop.trial, lanes, stride)
    else:
        lin = linearize_partials(prob, prop.trial, lanes, stride, active=prop.active)
    return lm_accept(prob, st, prop, lin)


def reset_counts():
    global linearize_launches, reduce_launches, lm_propose_launches, lm_accept_launches
    linearize_launches = reduce_launches = lm_propose_launches = lm_accept_launches = 0


def read_counts() -> dict:
    return dict(linearize=linearize_launches, reduce=reduce_launches,
                lm_propose=lm_propose_launches, lm_accept=lm_accept_launches)
