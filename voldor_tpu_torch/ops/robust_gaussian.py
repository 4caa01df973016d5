"""Truncated-Gaussian EM fit of the pose pool (port of
``voldor_tpu/ops/robust_gaussian.py:102``): the hand-written CUDA kernel
(``csrc/robust_gaussian_kernel.cu``), its wrapper and its plain version.

Inliers are samples with Mahalanobis z < trunc_sigma; the M-step
re-estimates mean and covariance from them with Ledoit-Wolf shrinkage. The
6x6 inverse is the JAX package's closed-form blockwise Schur inverse in
f32 (the pool is pre-scaled by the caller). Batched over leading dims.

* ``fit_robust_gaussian`` -- the wrapper. For CUDA tensors it launches the
  kernel: a block per search runs the whole EM (up to ``max_iters``
  iterations, the exit test inside the launch, no host read). For CPU
  tensors it calls the plain version; there is no fallback from one to
  the other.
* ``fit_robust_gaussian_reference`` -- the plain version: the JAX
  ``while_loop`` as a masked update with a host check every few steps.
  Its 3x3 products and the pool's sums are written out element by element
  (``_mm3``, ``block_sum``), in the order the kernel repeats.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from voldor_tpu_torch.ops import _build
from voldor_tpu_torch.ops.fisk import div_scalar
from voldor_tpu_torch.ops.reduce import THREADS, block_sum

_SYNC_EVERY = 8

# Calls that launched the CUDA kernel since the last reset (plain int;
# chip_smoke.py reads it to show the main path went through the kernel).
rg_kernel_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P] * 4 + [_P] * 6 + [_I] * 3 + [_F] * 4 + [_I, _P]


class RobustGaussianResult(NamedTuple):
    mean: torch.Tensor  # (..., D)
    covar: torch.Tensor  # (..., D, D)
    density: torch.Tensor  # (...,) inlier fraction of the valid pool
    iters: torch.Tensor  # (...,) int32
    reliable: torch.Tensor  # (...,) bool


def _lw_shrink(covar, lam):
    d = covar.shape[-1]
    tr = covar[..., 0, 0]
    for i in range(1, d):
        tr = tr + covar[..., i, i]
    m = div_scalar(tr, float(d))
    eye = torch.eye(d, dtype=covar.dtype, device=covar.device)
    return lam * m[..., None, None] * eye + (1.0 - lam) * covar


def _mm3(X, Y):
    """(..., 3, 3) product, entry (i, j) = (X_i0 Y_0j + X_i1 Y_1j) + X_i2 Y_2j."""
    return (X[..., :, 0:1] * Y[..., 0:1, :] + X[..., :, 1:2] * Y[..., 1:2, :]
            + X[..., :, 2:3] * Y[..., 2:3, :])


def _adj3(M):
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return torch.stack(
        [
            torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
            torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
            torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
        ],
        -2,
    )


def _det3(M):
    return (
        M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
        - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
        + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0])
    )


def _inv3(M):
    det = _det3(M)
    safe = torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    return _adj3(M) / safe[..., None, None], det


def _chol_inverse(covar):
    """(inverse, ok) of a 6x6 SPD matrix by blockwise Schur inversion;
    ok mirrors the reference's det > 0 gate."""
    A = covar[..., :3, :3]
    B = covar[..., :3, 3:]
    C = covar[..., 3:, :3]
    D = covar[..., 3:, 3:]
    Ainv, detA = _inv3(A)
    CA = _mm3(C, Ainv)
    S = D - _mm3(CA, B)
    Sinv, detS = _inv3(S)
    AB = _mm3(Ainv, B)
    top = torch.cat([Ainv + _mm3(_mm3(AB, Sinv), CA), _mm3(-AB, Sinv)], dim=-1)
    bot = torch.cat([_mm3(-Sinv, CA), Sinv], dim=-1)
    inv = torch.cat([top, bot], dim=-2)
    ok = (detA > 0) & (detS > 0) & torch.isfinite(inv).all(dim=(-2, -1))
    eye = torch.eye(6, dtype=covar.dtype, device=covar.device)
    return torch.where(ok[..., None, None], inv, eye), ok


def _sq_mahalanobis(inv, diff_t):
    """sum_i (inv @ diff)_i diff_i over (..., 6, P) columns, each product's
    terms added in turn."""
    t = inv[..., :, 0:1] * diff_t[..., 0:1, :]
    for j in range(1, diff_t.shape[-2]):
        t = t + inv[..., :, j:j + 1] * diff_t[..., j:j + 1, :]
    pr = t * diff_t
    z2 = pr[..., 0, :]
    for i in range(1, pr.shape[-2]):
        z2 = z2 + pr[..., i, :]
    return z2


def fit_robust_gaussian_reference(
    space: torch.Tensor,
    valid: torch.Tensor,
    mean0: torch.Tensor,
    covar0: torch.Tensor,
    trunc_sigma: float = 3.0,
    covar_reg_lambda: float = 0.001,
    epsilon: float = 1e-5,
    max_iters: int = 100,
) -> RobustGaussianResult:
    """The plain version of ``fit_robust_gaussian`` (same arguments and
    result)."""
    dt = space.dtype
    valid = valid.to(dt)
    n_valid = torch.clamp_min(block_sum(valid), 1.0)
    space_t = torch.where(valid[..., None, :] > 0, space.transpose(-1, -2), 0.0)  # (..., D, P)
    lam = float(covar_reg_lambda)
    batch = space.shape[:-2]
    D = space.shape[-1]
    dev = space.device

    it = torch.zeros(batch, dtype=torch.int32, device=dev)
    mean = mean0.to(dt).expand(batch + mean0.shape[-1:]).clone()
    covar = covar0.to(dt).expand(batch + covar0.shape[-2:]).clone()
    out_mean, out_covar = mean.clone(), covar.clone()
    out_density = torch.zeros(batch, dtype=dt, device=dev)
    prev_wsum = torch.zeros(batch, dtype=dt, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    reliable = torch.ones(batch, dtype=torch.bool, device=dev)

    for step in range(max_iters):
        if step % _SYNC_EVERY == 0 and bool(done.all()):
            break
        active = ~done
        if lam > 0:
            covar_r = torch.where((it > 0)[..., None, None], _lw_shrink(covar, lam), covar)
        else:
            covar_r = covar
        inv, ok = _chol_inverse(covar_r)
        z2 = _sq_mahalanobis(inv, space_t - mean[..., :, None])
        w = ((z2 < trunc_sigma * trunc_sigma) & (valid > 0)).to(dt)
        s = block_sum(torch.cat([w[..., None, :], space_t * w[..., None, :]], dim=-2))
        wsum = s[..., 0]
        fail = ~ok | ~torch.isfinite(wsum)
        converged = (torch.abs(wsum - prev_wsum) / n_valid < epsilon) & ~fail

        wsum_safe = torch.clamp_min(wsum, 1.0)
        new_mean = s[..., 1:] / wsum_safe[..., None]
        diff_new = space_t - new_mean[..., :, None]
        a = diff_new * w[..., None, :]
        prods = (a[..., :, None, :] * diff_new[..., None, :, :]).flatten(-3, -2)  # (..., D * D, P)
        new_covar = block_sum(prods).unflatten(-1, (D, D)) / wsum_safe[..., None, None]

        good = ~fail
        a1, a2, g2 = active[..., None], active[..., None, None], good[..., None, None]
        o_mean = torch.where(fail[..., None], out_mean, torch.where(converged[..., None], mean, new_mean))
        o_cov = torch.where(fail[..., None, None], out_covar, torch.where(converged[..., None, None], covar_r, new_covar))
        out_mean = torch.where(a1, o_mean, out_mean)
        out_covar = torch.where(a2, o_cov, out_covar)
        out_density = torch.where(active & ~fail, wsum / n_valid, out_density)
        mean = torch.where(a1 & good[..., None], new_mean, mean)
        covar = torch.where(a2 & g2, new_covar, covar)
        prev_wsum = torch.where(active & good, wsum, prev_wsum)
        reliable = torch.where(active, good, reliable)
        done = done | (active & (fail | converged))
        it = torch.where(active, it + 1, it)
    return RobustGaussianResult(
        mean=out_mean, covar=out_covar, density=out_density, iters=it, reliable=reliable
    )


def fit_robust_gaussian(
    space: torch.Tensor,
    valid: torch.Tensor,
    mean0: torch.Tensor,
    covar0: torch.Tensor,
    trunc_sigma: float = 3.0,
    covar_reg_lambda: float = 0.001,
    epsilon: float = 1e-5,
    max_iters: int = 100,
) -> RobustGaussianResult:
    """EM fit over a (..., P, 6) pool with a (..., P) validity mask; the
    exit structure follows the JAX package (convergence is tested before
    the new M-step is committed). CPU tensors take the plain version; a
    CUDA pool launches the kernel, one block per search."""
    args = (space, valid, mean0, covar0, trunc_sigma, covar_reg_lambda, epsilon, max_iters)
    if space.device.type == "cpu":
        return fit_robust_gaussian_reference(*args)
    if space.device.type != "cuda":
        raise ValueError(f"fit_robust_gaussian: unsupported device {space.device}")
    lead, (P, D) = space.shape[:-2], space.shape[-2:]
    if D != 6 or P < 1:
        raise ValueError(f"fit_robust_gaussian kernel takes a (..., P, 6) pool with P >= 1, "
                         f"got {tuple(space.shape)}")
    if max_iters < 0:
        raise ValueError("fit_robust_gaussian: max_iters must be >= 0")
    dev = space.device
    B = 1
    for n in lead:
        B *= n

    def on_card(x, shape, dtype):
        x = torch.as_tensor(x, device=dev)
        return x.to(dtype).expand(shape).reshape(B, *shape[len(lead):]).contiguous()

    sp = on_card(space, lead + (P, D), torch.float32)
    va = on_card(valid, lead + (P,), torch.float32)
    m0 = on_card(mean0, lead + (D,), torch.float32)
    c0 = on_card(covar0, lead + (D, D), torch.float32)
    mean = torch.empty((B, D), dtype=torch.float32, device=dev)
    covar = torch.empty((B, D, D), dtype=torch.float32, device=dev)
    density = torch.empty(B, dtype=torch.float32, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    reliable = torch.empty(B, dtype=torch.bool, device=dev)
    inliers = torch.empty((B, P), dtype=torch.uint8, device=dev)  # the kernel's scratch
    lam = float(covar_reg_lambda)
    global rg_kernel_launches
    fn = _build.function("robust_gaussian_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(sp.data_ptr(), va.data_ptr(), m0.data_ptr(), c0.data_ptr(),
                 mean.data_ptr(), covar.data_ptr(), density.data_ptr(), iters.data_ptr(),
                 reliable.data_ptr(), inliers.data_ptr(), B, P, int(max_iters),
                 trunc_sigma * trunc_sigma, lam, 1.0 - lam, epsilon,
                 THREADS, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fit_robust_gaussian kernel launch failed: cudaError {err}")
    rg_kernel_launches += 1
    return RobustGaussianResult(mean=mean.reshape(lead + (D,)), covar=covar.reshape(lead + (D, D)),
                                density=density.reshape(lead), iters=iters.reshape(lead),
                                reliable=reliable.reshape(lead))
