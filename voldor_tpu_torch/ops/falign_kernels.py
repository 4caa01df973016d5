"""Frame alignment's LM on hand-written CUDA kernels (``csrc/falign_lm.cu``,
``csrc/falign_linearize.cu``, both on ``csrc/falign_common.cuh``): their
wrappers, their launch counts and their plain versions.

The JAX package runs a chunk of LM iterations of every lane inside one
device program (``voldor_tpu/falign/solver.py:396`` ``lm_chunk_pairs``: a
vmapped ``lax.while_loop`` over ``_make_lm_step``'s body, :184-235, whose
residual, analytic Jacobian and ``_joint_normal_eq`` XLA fuses). Here too a
chunk is one launch:

* ``lm_chunk`` -- up to n LM iterations of every lane, one thread-block
  cluster a lane: per iteration the gauge weight, the damped carried system,
  its Cholesky factor (identity where it fails), two triangular solves, the
  masked step and the trial; the residual, its analytic 18-column gradient
  and their Gram reductions (see PairBlocks) at the trial, summed across
  the cluster in a fixed order (no float atomics: two launches on the same
  inputs are bitwise equal); the accept or reject, the gain-ratio damping,
  the stopping rules. Lanes that are done or out of budget keep their state.
* ``linearize_packed`` -- the linearisation at given parameters, one
  cluster a pair evaluation, the per-pair sums written directly (190, or 2
  in scores mode); ``linearize`` and ``score_sums`` serve the phase start,
  the covariances and the scores through it.

For CPU tensors every wrapper calls the plain version
(``falign.residual.pair_normal_blocks`` / ``pair_score_sums``,
``lm_chunk_reference``: ``lm_propose_reference`` -> the blocks ->
``lm_accept_reference`` per iteration); for CUDA tensors it launches its
kernel or raises. The wrappers take the solver's LaneProblem and
PairLmState (``falign/solver.py``) and return a state of the type they were
given.
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
lm_chunk_launches = 0  # falign_lm_chunk_kernel

THREADS = 512  # threads of a block; pixels of the strided grid per tile
# blocks of a cluster: 16, above the portable 8, because it shortens a
# batched LM iteration of the 4-lane batches by a quarter or more on an
# H100 (chip_smoke.py phase 6 times both; PERF.md)
CLUSTER = 16
# the one-shot linearise's clusters when not all of a launch's clusters of
# CLUSTER blocks fit on the card at once (an H100 holds 7 of the gradient
# mode's: a 4-pair batch's 8 would run in two waves; PERF.md)
CLUSTER_PORTABLE = 8
PAIR_GROUP = 16  # pairs the chunk kernel linearises between two cluster barriers
N_GRAM = 190  # the upper triangle of the 19 x 19 Gram matrix of [r, Jr, Jt]
N_SCORES = 2  # [visible pixels, sum of 1 - min(r^2, bound) / bound]
N_CONST_WORDS = 96  # 4-byte words of a pair's constants (PairConsts)
INFO = ("w2", "pred", "cur_cost", "step_inf", "ok", "active")  # a proposal's per-lane scalars

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LIN_ARGTYPES = ([_P, _P, _I, _I, _I, _P, _P, _P, _P] + [_I] * 6 + [_F] * 7
                 + [_P, _I, _P])
_CHUNK_ARGTYPES = ([_P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P] + [_I] * 6 + [_F] * 6
                   + [_P] * 19 + [_I, _P])


class Proposal(NamedTuple):
    """What lm_propose_reference hands the linearisation and the accept."""

    trial: torch.Tensor  # (L, N, 9) trial parameters (the current ones where inactive)
    info: torch.Tensor  # (L, 6) float: INFO's scalars, ok and active as 0 / 1
    active: torch.Tensor  # (L,) int32: the lane runs this iteration


def grid_size(h: int, w: int, stride: int) -> tuple[int, int]:
    """(rows, cols) of the strided ref grid (``arange(0, h, stride)``)."""
    return -(-h // stride), -(-w // stride)


def n_tiles(h: int, w: int, stride: int) -> int:
    """Tiles of THREADS pixels of a pair's strided grid."""
    hs, ws = grid_size(h, w, stride)
    return -(-(hs * ws) // THREADS)


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


def _dev_key(dev) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _check_problem(prob, params, lanes, dev):
    """Dtypes, shapes and contiguity of what the kernels read. The values of
    lanes and pairs are not read back (that would sync): lanes must index
    rows l * N of the maps and pairs local frames < N."""
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


_clusters: dict = {}


def _max_clusters(dev, entry: str, args: tuple, C: int) -> int:
    """How many clusters of C blocks the device holds at once
    (cudaOccupancyMaxActiveClusters, through the C entry point `entry`,
    which also sets the kernel's launch attributes): queried once per
    device, shape and C, before the first launch."""
    key = (_dev_key(dev), entry, args, C)
    if key not in _clusters:
        out = ctypes.c_int(0)
        fn = _build.function(entry, [_I] * (len(args) + 1) + [ctypes.POINTER(_I)])
        with torch.cuda.device(dev):
            _raise_on(fn(*args, C, ctypes.byref(out)), f"{entry} (cluster of {C})")
        _clusters[key] = out.value
    return _clusters[key]


def _check_cluster(dev, entry: str, args: tuple, C: int, smem: int, what: str):
    """Raise unless the device can hold one cluster of C blocks of THREADS
    threads with `smem` bytes of shared memory each."""
    n = _max_clusters(dev, entry, args, C)
    if n < 1:
        raise RuntimeError(
            f"{what}: a cluster of {C} blocks of {THREADS} threads with {smem} bytes of "
            f"shared memory each cannot be scheduled on this device "
            f"(cudaOccupancyMaxActiveClusters = {n})")


def lin_smem_bytes(n_pairs: int, scores: bool = False) -> int:
    """Dynamic shared memory of a block of the linearise kernel
    (csrc/falign_common.cuh:lin_smem_floats): the staged tile, the block's
    sums and the pairs' constants."""
    width = N_SCORES if scores else N_GRAM
    return 4 * (THREADS * 20 + -(-(n_pairs * width) // 4) * 4 + n_pairs * N_CONST_WORDS)


def linearize_packed(prob, params, lanes, stride: int, scores: bool = False,
                     bound: float = 1.0) -> torch.Tensor:
    """One launch of the linearise kernel (CUDA tensors only), a cluster a
    pair evaluation: per pair evaluation b = l * np + p, its 190 packed Gram
    sums (B, 190), or with ``scores`` the scores-mode sums (B, 2). Clusters
    of CLUSTER blocks where the card holds all B at once, else of
    CLUSTER_PORTABLE."""
    dev = _cuda_device(params, "falign_linearize")
    _check_problem(prob, params, lanes, dev)
    F, h, w, _ = prob.maps.packed.shape
    L, N, n_p = params.shape[0], prob.n_frames, prob.pairs.shape[0]
    entry, shape = "falign_linearize_max_clusters", (int(scores),)
    C = CLUSTER if _max_clusters(dev, entry, shape, CLUSTER) >= L * n_p else CLUSTER_PORTABLE
    _check_cluster(dev, entry, shape, C, lin_smem_bytes(1, scores), "falign_linearize")
    out = torch.empty((L * n_p, N_SCORES if scores else N_GRAM), dtype=torch.float32, device=dev)
    fx, fy, cx, cy, vbf, crw = prob.scalars
    global linearize_launches
    fn = _build.function("falign_linearize_launch", _LIN_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(prob.maps.packed.data_ptr(), prob.maps.weights.data_ptr(), F, h, w,
                 params.data_ptr(), lanes.data_ptr(), prob.pairs.data_ptr(),
                 prob.dim_mask.data_ptr(), L, N, n_p, int(stride), int(bool(prob.use_photo)),
                 int(scores), fx, fy, cx, cy, vbf, crw, float(bound), out.data_ptr(), C,
                 _stream(dev))
    _raise_on(err, "falign_linearize")
    linearize_launches += 1
    return out


def _plain_blocks(prob, params, lanes, stride: int) -> PairBlocks:
    return pair_normal_blocks(params, lanes, prob.pairs, prob.dim_mask, prob.maps, *prob.intr,
                              prob.vbf, prob.crw, prob.use_photo, stride)


def linearize(prob, params, lanes, stride: int) -> PairBlocks:
    """Per pair evaluation of the lanes, the linearisation's blocks at
    params (PairBlocks, B = L * np): the plain version on the CPU; on the
    card one launch of the linearise kernel."""
    if params.device.type == "cpu":
        return _plain_blocks(prob, params, lanes, stride)
    return unpack_blocks(linearize_packed(prob, params, lanes, stride))


def score_sums(prob, params, lanes, stride: int, bound: float):
    """Per pair evaluation, the visible pixels of the unweighted residual
    and the sum over them of 1 - min(r^2, bound) / bound: two (B,) float
    tensors. The plain version on the CPU; on the card one launch of the
    linearise kernel's scores mode."""
    if params.device.type == "cpu":
        return pair_score_sums(params, lanes, prob.pairs, prob.maps, *prob.intr, prob.vbf,
                               prob.crw, prob.use_photo, stride,
                               torch.tensor(float(bound), dtype=params.dtype))
    s = linearize_packed(prob, params, lanes, stride, scores=True, bound=bound)
    return s[:, 0], s[:, 1]


# --------------------------------------------------------------------------
# the LM step: plain versions
# --------------------------------------------------------------------------


def _gauge_sums(params, U):
    return params.reshape(params.shape[0], -1) @ U.T


def lm_propose_reference(prob, st, it_end) -> Proposal:
    """The chunk kernel's proposal, plain: the damped, gauge-regularised
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
    info = torch.stack([w2, pred, cur_cost, step_inf, ok.to(w2.dtype), active.to(w2.dtype)], dim=1)
    return Proposal(trial=trial, info=info, active=active.to(torch.int32))


def lm_accept_reference(prob, st, prop: Proposal, blocks: PairBlocks):
    """The chunk kernel's accept, plain: the trial's normal equations from
    its pairs' blocks, then ``accept_lanes``."""
    return accept_lanes(prob, st, prop, *assemble(blocks, prob.oh_r, prob.oh_t))


def accept_lanes(prob, st, prop: Proposal, trial_cost, H_t, g_t):
    """Given the trial's per-lane (cost, H, g): the accept decision, the
    gain-ratio (Nielsen) damping (a reject multiplies by 4) and the stopping
    rules (``solver.py:200-235``); lanes that were not active keep their
    state (``solver.py:424-441``)."""
    U = prob.gauge_U
    w2, pred, cur_cost, step_inf, ok, active = prop.info.unbind(1)
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


def lm_step_reference(prob, st, lanes, stride: int, it_end):
    """One LM iteration of every lane whose it < it_end and that is not
    done, in plain torch: propose, the blocks at the trial, accept."""
    prop = lm_propose_reference(prob, st, it_end)
    return lm_accept_reference(prob, st, prop, _plain_blocks(prob, prop.trial, lanes, stride))


def lm_chunk_reference(prob, st, lanes, stride: int, n: int, it_end=None):
    """The chunk kernel's plain version: n iterations of lm_step_reference;
    a lane runs while it < min(its it at entry + n, it_end) and it is not
    done."""
    end = st.it + n if it_end is None else torch.minimum(it_end, st.it + n)
    for _ in range(n):
        st = lm_step_reference(prob, st, lanes, stride, end)
    return st


# --------------------------------------------------------------------------
# the LM chunk: the kernel
# --------------------------------------------------------------------------

_smem_limit: dict = {}


def lm_smem_bytes(n_frames: int, n_gauge: int, n_pairs: int) -> int:
    """Dynamic shared memory of a block of the chunk kernel for a lane of
    n_frames frames, n_gauge gauge rows and n_pairs pairs
    (csrc/falign_lm.cu:chunk_smem_floats): the region that the damped
    system and then the cluster linearise of up to PAIR_GROUP pairs take in
    turn, the lane's vectors and gauge rows, and for D <= 32 its H, the
    trial's and U^T U (above, H and the trial's in global memory). It grows
    with D^2, not with the pairs."""
    D = 9 * n_frames
    region = max(D * (D + 1), lin_smem_bytes(min(n_pairs, PAIR_GROUP)) // 4)
    lane = 10 * D + n_gauge * D + n_gauge + (3 * D * D if D <= 32 else 0)
    return 4 * (-(-region // 4) * 4 + lane)


def _check_lm_fits(dev, n_frames: int, n_gauge: int, n_pairs: int):
    key = _dev_key(dev)
    if key not in _smem_limit:
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            _raise_on(_build.function("falign_lm_smem_limit", [_I, ctypes.POINTER(_I)])(
                key, ctypes.byref(out)), "falign_lm_smem_limit")
        _smem_limit[key] = out.value
    need = lm_smem_bytes(n_frames, n_gauge, n_pairs)
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


def lm_chunk(prob, st, lanes, stride: int, n: int, it_end=None):
    """Up to n LM iterations of every lane with no host read: a lane runs
    while it < (its it at entry) + n (and < it_end where given) and it is
    not done; the others keep their state (the vmapped ``lax.while_loop`` of
    ``solver.py:424-441``). CPU tensors: lm_chunk_reference. CUDA tensors:
    one launch of the chunk kernel, one cluster of CLUSTER blocks a lane,
    which writes the next state into new tensors."""
    if st.params.device.type == "cpu":
        return lm_chunk_reference(prob, st, lanes, stride, n, it_end)
    dev = _cuda_device(st.params, "falign_lm_chunk")
    L, N, n_p = st.params.shape[0], prob.n_frames, prob.pairs.shape[0]
    D = 9 * N
    U = prob.gauge_U
    K = U.shape[0]
    _check_problem(prob, st.params, lanes, dev)
    _check_state(st, L, D, dev)
    _check(U, "gauge_U", torch.float32, (K, D), dev)
    if it_end is not None:
        _check(it_end, "it_end", torch.int32, (L,), dev)
    if n < 0:
        raise ValueError(f"falign_lm_chunk: n = {n} iterations")
    _check_lm_fits(dev, N, K, n_p)
    _check_cluster(dev, "falign_lm_max_clusters", (N, K, n_p), CLUSTER, lm_smem_bytes(N, K, n_p),
                   "falign_lm_chunk")
    F, h, w, _ = prob.maps.packed.shape
    fx, fy, cx, cy, vbf, crw = prob.scalars
    out = type(st)(*(torch.empty_like(a) for a in st))
    # the trial's H of a lane above 32 parameters (it does not fit block 0's
    # shared memory beside the lane's damped system)
    work = torch.empty((L, D, D), dtype=torch.float32, device=dev) if D > 32 else None
    global lm_chunk_launches
    fn = _build.function("falign_lm_chunk_launch", _CHUNK_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(prob.maps.packed.data_ptr(), prob.maps.weights.data_ptr(), F, h, w,
                 lanes.data_ptr(), prob.pairs.data_ptr(), prob.dim_mask.data_ptr(), U.data_ptr(),
                 K, None if it_end is None else it_end.data_ptr(), L, N, n_p, int(n), int(stride),
                 int(bool(prob.use_photo)), fx, fy, cx, cy, vbf, crw, *_state_ptrs(st),
                 *_state_ptrs(out), None if work is None else work.data_ptr(), None, None,
                 CLUSTER, _stream(dev))
    _raise_on(err, "falign_lm_chunk")
    lm_chunk_launches += 1
    return out


def lm_iteration(prob, st, lanes, stride: int, it_end):
    """One damped-LM iteration of every lane whose it < it_end and that is
    not done; the others keep their state. CPU: lm_step_reference; the
    card: the chunk kernel with n = 1, one launch and no host read."""
    if st.params.device.type == "cpu":
        return lm_step_reference(prob, st, lanes, stride, it_end)
    return lm_chunk(prob, st, lanes, stride, 1, it_end=it_end)


def reset_counts():
    global linearize_launches, lm_chunk_launches
    linearize_launches = lm_chunk_launches = 0


def read_counts() -> dict:
    return dict(linearize=linearize_launches, lm_chunk=lm_chunk_launches)
