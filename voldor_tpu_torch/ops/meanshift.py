"""Gaussian-kernel meanshift mode seeking (port of
``voldor_tpu/ops/meanshift.py:38``): the hand-written CUDA kernel
(``csrc/meanshift_kernel.cu``), its wrapper and its plain version.

Batched over any leading dims (the jacobi sweep runs one search per window
frame). The JAX package's search is one jitted ``lax.while_loop``; here:

* ``meanshift`` -- the wrapper. For CUDA tensors it launches the kernel: a
  block per search runs the whole search (the valid count, the init trials
  and their early stop, up to ``max_iters`` mean-shift steps with the stop
  test) inside the launch, with no host read. For CPU tensors it calls the
  plain version. There is no fallback from one to the other.
* ``meanshift_reference`` -- the plain version: all ``max_init_trials``
  candidates are scored at once and the early stop (best confidence above
  ``good_init_confidence * n_valid``) is replayed on the scores, so the
  chosen start is the one the sequential loop picks; then a masked update
  per search (a finished search keeps its state), with the "all finished"
  test read on the host every few steps. Every pool sum is ``block_sum``'s
  fixed order, which the kernel repeats.

The init-trial draws are split out (``draw_meanshift_trials``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from voldor_tpu_torch.ops import _build
from voldor_tpu_torch.ops.fisk import div_scalar
from voldor_tpu_torch.ops.reduce import THREADS, block_sum
from voldor_tpu_torch.utils.profiling import host_read

_SYNC_EVERY = 8  # iterations between host checks of "all converged"
MAX_D = 8  # the kernel's widest pool row
MAX_TRIALS = 32  # the kernel's most init trials

# Calls that launched the CUDA kernel since the last reset (plain int;
# chip_smoke.py reads it to show the main path went through the kernel).
meanshift_kernel_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P] * 5 + [_P] * 4 + [_I] * 5 + [_F] * 3 + [_I, _P]


class MeanshiftResult(NamedTuple):
    mean: torch.Tensor  # (..., D)
    confidence: torch.Tensor  # (...,) sum of kernel weights / n_valid
    iters: torch.Tensor  # (...,) int32
    n_valid: torch.Tensor  # (...,) int32


def _weights(space_t, valid, mean, kernel_var2):
    """space_t: (..., D, P); mean: (..., D, T) -> (..., T, P) weights
    exp(-|x - m|^2 / (2 kernel_var)), the squares added in turn over D."""
    d = space_t[..., :, None, :] - mean[..., :, :, None]
    sq = d * d
    d2 = sq[..., 0, :, :]
    for k in range(1, sq.shape[-3]):
        d2 = d2 + sq[..., k, :, :]
    return torch.exp(div_scalar(-d2, kernel_var2)) * valid[..., None, :]


def draw_meanshift_trials(gen: torch.Generator, valid: torch.Tensor, max_init_trials: int):
    """(..., max_init_trials) sample indices drawn with probability
    proportional to ``valid`` ((..., P) {0,1} weights)."""
    lead = valid.shape[:-1]
    w = valid.reshape(-1, valid.shape[-1]).to(torch.float32)
    w = torch.where(w.sum(dim=-1, keepdim=True) > 0, w, torch.ones_like(w))
    idx = torch.multinomial(w, max_init_trials, replacement=True, generator=gen)
    return idx.reshape(lead + (max_init_trials,))


def meanshift_reference(
    space: torch.Tensor,
    valid: torch.Tensor,
    kernel_var: float,
    init_mean: torch.Tensor,
    use_external_init_mean: torch.Tensor,
    trial_idx: torch.Tensor,
    epsilon: float = 1e-5,
    max_iters: int = 100,
    good_init_confidence: float = 0.5,
) -> MeanshiftResult:
    """The plain version of ``meanshift`` (same arguments and result)."""
    valid = valid.to(space.dtype)
    space_t = torch.where(valid[..., None, :] > 0, space.transpose(-1, -2), 0.0)  # (..., D, P)
    dev = space.device
    kv2 = 2.0 * kernel_var
    n_valid = torch.clamp_min(block_sum(valid), 1.0)

    # init trials: score every candidate, then replay the early stop
    cands = torch.take_along_dim(space_t, trial_idx[..., None, :], dim=-1)  # (..., D, T)
    confs = block_sum(_weights(space_t, valid, cands, kv2))
    best_so_far = torch.cummax(confs, dim=-1).values
    over = best_so_far > good_init_confidence * n_valid[..., None]
    # trial t runs iff no earlier trial already pushed the best over the bar
    ran = torch.cat([torch.ones_like(over[..., :1]), ~over[..., :-1]], dim=-1)
    ran = torch.cumprod(ran.to(torch.int32), dim=-1) > 0
    pick = torch.argmax(torch.where(ran, confs, -torch.inf), dim=-1)  # first max
    trial_mean = torch.take_along_dim(cands, pick[..., None, None], dim=-1)[..., 0]
    mean = torch.where(use_external_init_mean[..., None], init_mean.to(space.dtype), trial_mean)

    it = torch.zeros(space.shape[:-2], dtype=torch.int32, device=dev)
    conf = torch.zeros(space.shape[:-2], dtype=space.dtype, device=dev)
    disp = torch.full(space.shape[:-2], torch.inf, dtype=space.dtype, device=dev)
    for step in range(max_iters):
        if step % _SYNC_EVERY == 0 and not host_read(
                "meanshift.stop", bool, ((it < max_iters) & (disp >= epsilon)).any()):
            break
        active = (it < max_iters) & (disp >= epsilon)

        # (..., 1 + D): the weight's sum, then each weighted coordinate's
        w = _weights(space_t, valid, mean[..., None], kv2)
        s = block_sum(torch.cat([w, space_t * w], dim=-2))
        wsum = torch.clamp_min(s[..., 0], 1e-30)
        new_mean = s[..., 1:] / wsum[..., None]
        dm = mean - new_mean
        sq = dm * dm
        d2 = sq[..., 0]
        for k in range(1, sq.shape[-1]):
            d2 = d2 + sq[..., k]
        new_disp = torch.sqrt(d2)
        it = torch.where(active, it + 1, it)
        mean = torch.where(active[..., None], new_mean, mean)
        conf = torch.where(active, wsum / n_valid, conf)
        disp = torch.where(active, new_disp, disp)
    return MeanshiftResult(mean=mean, confidence=conf, iters=it, n_valid=valid.sum(dim=-1).to(torch.int32))


def meanshift(
    space: torch.Tensor,
    valid: torch.Tensor,
    kernel_var: float,
    init_mean: torch.Tensor,
    use_external_init_mean: torch.Tensor,
    trial_idx: torch.Tensor,
    epsilon: float = 1e-5,
    max_iters: int = 100,
    good_init_confidence: float = 0.5,
) -> MeanshiftResult:
    """Mode-seek over a (..., P, D) pool.

    valid: (..., P) {0,1}; init_mean: (..., D) warm start used where
    ``use_external_init_mean`` (..., bool); trial_idx: (..., T) init-trial
    sample indices (``draw_meanshift_trials``). CPU tensors take the plain
    version; a CUDA pool (D <= 8, 1 <= T <= 32) launches the kernel, one
    block per search, on the pool's card.
    """
    args = (space, valid, kernel_var, init_mean, use_external_init_mean, trial_idx, epsilon,
            max_iters, good_init_confidence)
    if space.device.type == "cpu":
        return meanshift_reference(*args)
    if space.device.type != "cuda":
        raise ValueError(f"meanshift: unsupported device {space.device}")
    lead, (P, D) = space.shape[:-2], space.shape[-2:]
    T = trial_idx.shape[-1]
    if not (1 <= D <= MAX_D and 1 <= T <= MAX_TRIALS and P >= 1):
        raise ValueError(f"meanshift kernel takes 1 <= D <= {MAX_D}, 1 <= T <= {MAX_TRIALS} "
                         f"trials and P >= 1 rows, got D={D}, T={T}, P={P}")
    if max_iters < 0:
        raise ValueError("meanshift: max_iters must be >= 0")
    dev = space.device
    B = 1
    for n in lead:
        B *= n

    def on_card(x, shape, dtype):
        x = torch.as_tensor(x, device=dev)
        return x.to(dtype).expand(shape).reshape(B, *shape[len(lead):]).contiguous()

    sp = on_card(space, lead + (P, D), torch.float32)
    va = on_card(valid, lead + (P,), torch.float32)
    init = on_card(init_mean, lead + (D,), torch.float32)
    use = on_card(use_external_init_mean, lead, torch.bool)
    trials = on_card(trial_idx, lead + (T,), torch.int64)
    mean = torch.empty((B, D), dtype=torch.float32, device=dev)
    conf = torch.empty(B, dtype=torch.float32, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    n_valid = torch.empty(B, dtype=torch.int32, device=dev)
    global meanshift_kernel_launches
    fn = _build.function("meanshift_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(sp.data_ptr(), va.data_ptr(), init.data_ptr(), use.data_ptr(), trials.data_ptr(),
                 mean.data_ptr(), conf.data_ptr(), iters.data_ptr(), n_valid.data_ptr(),
                 B, P, D, T, int(max_iters), 2.0 * kernel_var, epsilon, good_init_confidence,
                 THREADS, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"meanshift kernel launch failed: cudaError {err}")
    meanshift_kernel_launches += 1
    return MeanshiftResult(mean=mean.reshape(lead + (D,)), confidence=conf.reshape(lead),
                           iters=iters.reshape(lead), n_valid=n_valid.reshape(lead))
