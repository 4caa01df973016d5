"""Fused multi-frame Fisk cost of candidate depth maps, with the
normalisation and the per-pixel accept of a proposal batch: the
hand-written CUDA kernel (``csrc/cost_kernel.cu``), its wrappers and their
plain versions.

Counterpart of ``voldor_tpu/ops/pallas_cost.py`` (``_cost_kernel`` :33,
``cost_map_tracked_pallas`` :118, ``normalize_cost`` :225) and of the
accept of ``voldor_tpu/vo/em.py:optimize_depth_batched`` (:596-610).

* ``cost_map_score`` — the normalised (K, h, w) cost of K candidates.
* ``cost_map_accept`` — scores a proposal batch and accepts, per pixel, the
  first argmin over the kept candidates where it lowers the current cost.

For CUDA tensors both launch the kernel (each launch counted in
``cost_kernel_launches``, the score-mode ones also in
``cost_score_launches``, and by mode, K and masks in
``cost_launch_shapes``); for CPU tensors they compose the plain versions,
``cost_map_tracked_reference`` (a transcription of
``em.compute_cost_map_tracked`` (em.py:208-268) and ``em.prior_cost_sums``
(em.py:271-298), batched over the K candidates, returning raw sums) ->
``normalize_cost`` -> ``accept_reference``. There is no fallback from one
to the other. The wrappers make no host-device sync: the pose rows are
built on the device and the kernel reads them there.

``geometry`` chooses each launch's tile (a block per ``tile`` consecutive
pixels and all K candidates) and gives the threads, shared bytes and grid
that follow from it; the C entry point takes the tile, derives the rest
the same way and refuses a tile that does not fit. The kernel is built
with the package's other kernels by ``ops/_build.py``.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import torch

from voldor_tpu_torch.ops import _build, fisk

MAX_N = 8  # window frames the kernel takes (COST_MAX_N)
MAX_D = 4  # depth priors (COST_MAX_D)
MAX_K = 16  # candidates per launch (COST_MAX_K)

# Launches of the CUDA kernel since the last reset (plain ints; the chip
# smoke test reads them to show the main path went through the kernel).
cost_kernel_launches = 0  # every launch, score and accept
cost_score_launches = 0  # the score-mode ones among them
# every launch by ("score" or "accept", K, masks given)
cost_launch_shapes: collections.Counter = collections.Counter()

_SCORE, _ACCEPT = 0, 1


class _CostParams(ctypes.Structure):
    _fields_ = [
        ("fx", ctypes.c_float), ("fy", ctypes.c_float),
        ("cx", ctypes.c_float), ("cy", ctypes.c_float),
        ("lam", ctypes.c_float), ("arf", ctypes.c_float),
        ("bf", ctypes.c_float), ("omega", ctypes.c_float),
        ("n_frames", ctypes.c_int), ("active_n", ctypes.c_int),
        ("n_priors", ctypes.c_int), ("k", ctypes.c_int),
        ("h", ctypes.c_int), ("w", ctypes.c_int),
        ("tile", ctypes.c_int),
    ]


_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 14 + [ctypes.POINTER(_CostParams), ctypes.c_void_p]
)


SMEM_LIMIT = 48 * 1024  # dynamic shared bytes a block gets without opting in
MAX_THREADS = 768  # the kernel's launch bounds (two such blocks an SM: 40 registers)


class Geometry(NamedTuple):
    """One launch: a block takes ``tile`` consecutive pixels of the map and
    all K candidates (thread k * tile + j: candidate k at pixel j)."""

    tile: int  # pixels a block, a multiple of 32
    threads: int  # K * tile
    smem: int  # dynamic shared bytes a block
    grid: int  # blocks: ceil(h * w / tile)


def geometry(K: int, N: int, D: int, h: int, w: int) -> Geometry:
    """The kernel's launch geometry for K candidates, N window frames and D
    priors over an h x w map: 128 pixels a block at K = 1, else 32 (a
    warp a candidate), the fastest of 32-256 on an H100 (PERF.md). Shared
    memory a block: per pixel and frame the staged planes and the Fisk
    model (4 float pairs and the in-bounds byte), per pixel and prior 5
    floats, per pixel and candidate the accept's cost and depth
    (``cost_smem_bytes`` in csrc/cost_kernel.cu, which derives the same
    from the tile)."""
    tile = 128 if K == 1 else 32
    smem = tile * (33 * N + 20 * D + 8 * K)
    if K * tile > MAX_THREADS or smem > SMEM_LIMIT:
        raise ValueError(f"cost kernel: K={K} N={N} D={D} needs {K * tile} threads and {smem} "
                         f"shared bytes a block (at most {MAX_THREADS} and {SMEM_LIMIT})")
    return Geometry(tile, K * tile, smem, -(-(h * w) // tile))


def normalize_cost(cost_sum, weight_sum):
    """Final per-pixel cost: cost / max(weight, FLT_EPSILON), +inf where
    the weight sum is 0 (``pallas_cost.py:225``)."""
    cost = cost_sum / torch.clamp_min(weight_sum, 1.1920929e-07)
    return torch.where(weight_sum == 0, torch.inf, cost)


def _prior_stack(prior_samples):
    if prior_samples is None or prior_samples[0].shape[0] == 0:
        return None
    return prior_samples


def cost_map_tracked_reference(
    cands, track, track_inb, rigidness, Rs, ts, active_n, p, prior_samples=None
):
    """Plain PyTorch version: raw (cost_sum, weight_sum), each (K, h, w).

    track = (tx, ty, obx, oby), each (N, h, w), or None for a prior-only
    cost; prior_samples = (target (D,h,w), weight (D,h,w), dp_Rs, dp_ts) or
    None."""
    K, h, w = cands.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, device=cands.device), torch.arange(w, device=cands.device),
        indexing="ij",
    )
    ox = fisk.div_scalar(xs.float() - p.cx, p.fx) * cands
    oy = fisk.div_scalar(ys.float() - p.cy, p.fy) * cands
    oz = cands
    cost = torch.zeros_like(cands)
    wsum = torch.zeros_like(cands)

    if track is not None:
        tx, ty, obx, oby = track
        cx, cy, cz = ox, oy, oz
        for f in range(min(tx.shape[0], int(active_n))):
            R, t = Rs[f], ts[f]
            nx = R[0, 0] * cx + R[0, 1] * cy + R[0, 2] * cz + t[0]
            ny = R[1, 0] * cx + R[1, 1] * cy + R[1, 2] * cz + t[1]
            nz = R[2, 0] * cx + R[2, 1] * cy + R[2, 2] * cz + t[2]
            safe_nz = torch.where(torch.abs(nz) < 1e-12, 1e-12, nz)
            px2 = (p.fx * nx + p.cx * safe_nz) / safe_nz
            py2 = (p.fy * ny + p.cy * safe_nz) / safe_nz
            use = track_inb[f] & (nz > 0)
            r = fisk.rigidness_xy(px2 - tx[f], py2 - ty[f], obx[f], oby[f], p.lam, p.abs_resize_factor)
            rig = rigidness[f]
            cost = cost + torch.where(use, -rig * torch.log(torch.clamp_min(r, 1e-30)), 0.0)
            wsum = wsum + torch.where(use, rig, 0.0)
            cx, cy, cz = nx, ny, nz

    ps = _prior_stack(prior_samples)
    if ps is not None:
        target, weight, dp_Rs, dp_ts = ps
        pc = torch.zeros_like(cands)
        pw = torch.zeros_like(cands)
        for d in range(target.shape[0]):
            R, t = dp_Rs[d], dp_ts[d]
            tgt, wgt = target[d], weight[d]
            nz = R[2, 0] * ox + R[2, 1] * oy + R[2, 2] * oz + t[2]
            use = (nz > 0) & (tgt > 0) & (wgt > 0)
            r = fisk.depth_rigidness(
                torch.clamp_min(nz, 1e-12), torch.clamp_min(tgt, 1e-12),
                p.basefocal, p.omega, p.abs_resize_factor,
            )
            pc = pc + torch.where(use, -wgt * torch.log(torch.clamp_min(r, 1e-30)), 0.0)
            pw = pw + torch.where(use, wgt, 0.0)
        cost = cost + pc
        wsum = wsum + pw
    return cost, wsum


def _check(name, t, shape, dtypes, device, contiguous=True):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _pose_rows(Rs, ts, n):
    return torch.cat([Rs.reshape(n, 9), ts.reshape(n, 3)], dim=-1)


def accept_reference(depth, cost, costs, cands, masks=None):
    """Plain per-pixel accept of a scored proposal batch (``em.py:596-610``):
    masked-out candidates cost +inf; the first argmin over K wins (ties go
    to the lowest k, and a NaN among the kept costs wins, as in
    ``jnp.min`` / ``jnp.argmin``); the pixel takes it where its cost is
    below the current one. Returns new (depth, cost); masks None keeps
    every candidate."""
    best_cost = torch.full_like(cost, torch.inf)
    best_cand = cands[0]
    for k in range(cands.shape[0]):
        c = costs[k] if masks is None else torch.where(masks[k], costs[k], torch.inf)
        take = ~torch.isnan(best_cost) & (torch.isnan(c) | (c < best_cost))
        best_cost = torch.where(take, c, best_cost)
        best_cand = torch.where(take, cands[k], best_cand)
    better = best_cost < cost
    return torch.where(better, best_cand, depth), torch.where(better, best_cost, cost)


def _bind(mode, cands, track, track_inb, rigidness, Rs, ts, active_n, p, prior_samples,
          masks=None, depth=None, cost=None, out=None):
    """Check the operands and bind one launch: (C function, its arguments,
    the pose rows they point to, which must outlive the call)."""
    dev = cands.device
    if dev.type != "cuda":
        raise ValueError(f"cost kernel: unsupported device {dev}")
    f32 = (torch.float32,)
    K, h, w = cands.shape
    tx, ty, obx, oby = track
    N = tx.shape[0]
    if not 1 <= K <= MAX_K:
        raise ValueError(f"cost kernel takes 1..{MAX_K} candidates, got {K}")
    if not 1 <= N <= MAX_N:
        raise ValueError(f"cost kernel takes 1..{MAX_N} window frames, got {N}")
    _check("cands", cands, (K, h, w), f32, dev)
    for name, t in (("tx", tx), ("ty", ty), ("obx", obx), ("oby", oby), ("rigidness", rigidness)):
        _check(name, t, (N, h, w), f32, dev)
    _check("track_inb", track_inb, (N, h, w), (torch.bool, torch.uint8), dev)
    _check("Rs", Rs, (N, 3, 3), f32, dev, contiguous=False)
    _check("ts", ts, (N, 3), f32, dev, contiguous=False)
    poses = [_pose_rows(Rs, ts, N)]
    ps = _prior_stack(prior_samples)
    D = 0
    ptgt = pwgt = None
    if ps is not None:
        ptgt, pwgt, dp_Rs, dp_ts = ps
        D = ptgt.shape[0]
        if D > MAX_D:
            raise ValueError(f"cost kernel takes at most {MAX_D} depth priors, got {D}")
        _check("prior target", ptgt, (D, h, w), f32, dev)
        _check("prior weight", pwgt, (D, h, w), f32, dev)
        _check("prior Rs", dp_Rs, (D, 3, 3), f32, dev, contiguous=False)
        _check("prior ts", dp_ts, (D, 3), f32, dev, contiguous=False)
        poses.append(_pose_rows(dp_Rs, dp_ts, D))
    if masks is not None:
        _check("masks", masks, (K, h, w), (torch.bool, torch.uint8), dev)
    for name, t in (("depth", depth), ("cost", cost)):
        if t is not None:
            _check(name, t, (h, w), f32, dev)
    poses = torch.cat(poses).contiguous()  # stays on the device

    prm = _CostParams()
    prm.fx, prm.fy, prm.cx, prm.cy = p.fx, p.fy, p.cx, p.cy
    prm.lam, prm.arf, prm.bf, prm.omega = p.lam, p.abs_resize_factor, p.basefocal, p.omega
    prm.n_frames, prm.active_n, prm.n_priors, prm.k = N, int(active_n), D, K
    prm.h, prm.w = h, w
    prm.tile = geometry(K, N, D, h, w).tile

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (
        mode, poses.data_ptr(), cands.data_ptr(), tx.data_ptr(), ty.data_ptr(),
        obx.data_ptr(), oby.data_ptr(), rigidness.data_ptr(), track_inb.data_ptr(),
        ptr(ptgt), ptr(pwgt), ptr(masks), ptr(depth), ptr(cost), ptr(out),
        ctypes.byref(prm), torch.cuda.current_stream(dev).cuda_stream,
    )
    return _build.function("cost_kernel_launch", _ARGTYPES), args, poses


def _launch(mode, *operands, **kw):
    fn, args, _poses = _bind(mode, *operands, **kw)
    with torch.cuda.device(operands[0].device):  # the launch goes to the current device
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"cost kernel launch failed: cudaError {err}")
    global cost_kernel_launches, cost_score_launches
    cost_kernel_launches += 1
    if mode == _SCORE:
        cost_score_launches += 1
    cost_launch_shapes["score" if mode == _SCORE else "accept", operands[0].shape[0],
                       kw.get("masks") is not None] += 1


def cost_map_score(cands, track, track_inb, rigidness, Rs, ts, active_n, p, prior_samples=None):
    """Normalised (K, h, w) cost of the K candidate depth maps: the flow arm
    (track = (tx, ty, obx, oby), each (N, h, w)) plus the fused prior arm
    (prior_samples = (target (D,h,w), weight (D,h,w), dp_Rs, dp_ts) or
    None). CPU tensors take the plain version; CUDA tensors launch the
    kernel in score mode."""
    if cands.device.type == "cpu":
        return normalize_cost(*cost_map_tracked_reference(
            cands, track, track_inb, rigidness, Rs, ts, active_n, p, prior_samples))
    out = torch.empty_like(cands)
    _launch(_SCORE, cands, track, track_inb, rigidness, Rs, ts, active_n, p, prior_samples,
            out=out)
    return out


def cost_map_accept(depth, cost, cands, masks, track, track_inb, rigidness, Rs, ts, active_n,
                    p, prior_samples=None):
    """Score a (K, h, w) proposal batch and accept it per pixel
    (``accept_reference``'s semantics); masks: (K, h, w) bool, or None for
    all kept. Returns (depth, cost). CPU tensors compose the plain versions
    and return new tensors; CUDA tensors launch the kernel in accept mode,
    which updates ``depth`` and ``cost`` in place and returns them."""
    if cands.device.type == "cpu":
        costs = normalize_cost(*cost_map_tracked_reference(
            cands, track, track_inb, rigidness, Rs, ts, active_n, p, prior_samples))
        return accept_reference(depth, cost, costs, cands, masks)
    _launch(_ACCEPT, cands, track, track_inb, rigidness, Rs, ts, active_n, p, prior_samples,
            masks=masks, depth=depth, cost=cost)
    return depth, cost

