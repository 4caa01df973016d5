"""Gaussian-kernel meanshift mode seeking (port of
``voldor_tpu/ops/meanshift.py:38``).

Batched over any leading dims (the jacobi sweep runs one search per window
frame). The JAX ``while_loop``s become:

* the init trials: all ``max_init_trials`` candidates are scored at once and
  the early stop (best confidence above ``good_init_confidence * n_valid``)
  is replayed on the scores, so the chosen start is the one the sequential
  loop picks;
* the iterations: a masked update per search (a finished search keeps its
  state), with the "all finished" test read on the host every few steps.

The init-trial draws are split out (``draw_meanshift_trials``).

Under an active mesh with a ``hyp`` axis (``parallel/hints.py``) the pool
is cut into one slice per device along that axis: each device reduces the
kernel weights of its slice, and the partial sums are added on the pool's
device (the JAX package's shard_hint makes XLA insert the same psums,
``vo/pose_step.py:490-495``). The trials are drawn once, from the whole
pool, as without a mesh.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from voldor_tpu_torch.parallel import hints

_SYNC_EVERY = 8  # iterations between host checks of "all converged"


class MeanshiftResult(NamedTuple):
    mean: torch.Tensor  # (..., D)
    confidence: torch.Tensor  # (...,) sum of kernel weights / n_valid
    iters: torch.Tensor  # (...,) int32
    n_valid: torch.Tensor  # (...,) int32


def _weights(space_t, valid, mean, kernel_var):
    """space_t: (..., D, P); mean: (..., D, T) -> (..., T, P) weights."""
    d2 = torch.sum((space_t[..., :, None, :] - mean[..., :, :, None]) ** 2, dim=-3)
    return torch.exp(-d2 / (2.0 * kernel_var)) * valid[..., None, :]


def draw_meanshift_trials(gen: torch.Generator, valid: torch.Tensor, max_init_trials: int):
    """(..., max_init_trials) sample indices drawn with probability
    proportional to ``valid`` ((..., P) {0,1} weights)."""
    lead = valid.shape[:-1]
    w = valid.reshape(-1, valid.shape[-1]).to(torch.float32)
    w = torch.where(w.sum(dim=-1, keepdim=True) > 0, w, torch.ones_like(w))
    idx = torch.multinomial(w, max_init_trials, replacement=True, generator=gen)
    return idx.reshape(lead + (max_init_trials,))


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
    sample indices (``draw_meanshift_trials``).
    """
    valid = valid.to(space.dtype)
    space_t = torch.where(valid[..., None, :] > 0, space.transpose(-1, -2), 0.0)  # (..., D, P)
    dev = space.device
    # the pool's shards: the whole pool, or one slice per device of the
    # active mesh's hyp axis, whose partial sums are added on `dev`
    hyp = hints.axis_devices("hyp")
    if hyp is None:
        shards = [(space_t, valid)]
    else:
        shards = list(zip(hints.split(space_t, hyp, -1), hints.split(valid, hyp, -1)))

    def pool_sum(fn):
        return hints.sum_partials([fn(st, v) for st, v in shards], dev)

    n_valid = torch.clamp_min(pool_sum(lambda st, v: v.sum(dim=-1)), 1.0)

    # init trials: score every candidate, then replay the early stop
    T = trial_idx.shape[-1]
    cands = torch.take_along_dim(space_t, trial_idx[..., None, :], dim=-1)  # (..., D, T)
    confs = pool_sum(lambda st, v: _weights(st, v, cands.to(st.device), kernel_var).sum(dim=-1))
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
        if step % _SYNC_EVERY == 0 and not bool(((it < max_iters) & (disp >= epsilon)).any()):
            break
        active = (it < max_iters) & (disp >= epsilon)
        ws = [_weights(st, v, mean.to(st.device)[..., None], kernel_var)[..., 0, :]
              for st, v in shards]  # (..., P) per shard
        wsum = torch.clamp_min(hints.sum_partials([w.sum(dim=-1) for w in ws], dev), 1e-30)
        new_mean = hints.sum_partials(
            [(st @ w[..., None])[..., 0] for (st, _), w in zip(shards, ws)], dev
        ) / wsum[..., None]
        new_disp = torch.linalg.norm(mean - new_mean, dim=-1)
        it = torch.where(active, it + 1, it)
        mean = torch.where(active[..., None], new_mean, mean)
        conf = torch.where(active, wsum / n_valid, conf)
        disp = torch.where(active, new_disp, disp)
    return MeanshiftResult(mean=mean, confidence=conf, iters=it, n_valid=valid.sum(dim=-1).to(torch.int32))
