"""HMM forward-backward smoothing of rigidness maps
(port of ``voldor_tpu/ops/fb_smooth.py:134-168``): the hand-written CUDA
kernel (``csrc/fb_smooth_kernel.cu``), its wrapper and its plain version.

A 2-state HMM smooths each map along rows, then along columns: forward and
backward message passes, then a pointwise posterior. The sequential
probability-domain recurrences are kept as they are (every carried value
stays in [0, 1]).

* ``fb_smooth`` — the wrapper. For CUDA tensors it launches the kernel (a
  row launch and a column launch, counted once in
  ``fb_smooth_kernel_launches``); for CPU tensors it calls the plain
  version. There is no fallback from one to the other.
* ``fb_smooth_reference`` — the plain PyTorch version: each line step is a
  handful of elementwise ops over all lines at once, so one call is about
  2 * (h + w) sequential steps.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from voldor_tpu_torch.ops import _build

# Calls that launched the CUDA kernel since the last reset (plain int; the
# chip smoke test reads it to show the main path went through the kernel).
fb_smooth_kernel_launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float] * 3 + [ctypes.c_void_p]


def _posterior(fwd, bwd):
    s1 = fwd * bwd
    s0 = (1.0 - fwd) * (1.0 - bwd)
    return s1 / torch.clamp_min(s0 + s1, 1e-30)


def _line(prob, e0, ncp, one_m_ncp):
    """Smooth along the last axis of ``prob`` (any leading dims)."""
    n = prob.shape[-1]
    fwd = torch.empty_like(prob)
    bwd = torch.empty_like(prob)
    prev = prob[..., 0]
    for i in range(n):
        e1 = prob[..., i]
        s0 = (prev * one_m_ncp + (1.0 - prev) * ncp) * e0
        s1 = (prev * ncp + (1.0 - prev) * one_m_ncp) * e1
        prev = s1 / (s0 + s1)
        fwd[..., i] = prev
    prev = prob[..., n - 1]
    for i in range(n - 1, -1, -1):
        e1 = prob[..., i]
        s0 = prev * e1 * one_m_ncp + (1.0 - prev) * ncp * e0
        s1 = prev * e1 * ncp + (1.0 - prev) * one_m_ncp * e0
        prev = s1 / (s0 + s1)
        bwd[..., i] = prev
    return _posterior(fwd, bwd)


def _constants(s0_ems_prob, no_change_prob):
    """(e0, ncp, 1 - ncp), rounded to f32 first, as the JAX package computes them."""
    ncp = np.float32(no_change_prob)
    return float(np.float32(s0_ems_prob)), float(ncp), float(np.float32(1.0) - ncp)


def fb_smooth_reference(prob: torch.Tensor, s0_ems_prob: float, no_change_prob: float) -> torch.Tensor:
    """Plain version: smooth a (..., h, w) stack of probability maps, rows
    then columns."""
    consts = _constants(s0_ems_prob, no_change_prob)
    prob = _line(prob, *consts)
    return _line(prob.transpose(-1, -2), *consts).transpose(-1, -2).contiguous()


def fb_smooth(prob: torch.Tensor, s0_ems_prob: float, no_change_prob: float) -> torch.Tensor:
    """Smooth a stack of probability maps, rows then columns. CPU tensors
    take the plain version; a CUDA tensor must be a contiguous (M, h, w)
    float32 stack with M >= 1, and launches the kernel."""
    if prob.device.type == "cpu":
        return fb_smooth_reference(prob, s0_ems_prob, no_change_prob)
    if prob.device.type != "cuda":
        raise ValueError(f"fb_smooth: unsupported device {prob.device}")
    if prob.dtype != torch.float32:
        raise TypeError(f"fb_smooth kernel takes float32, got {prob.dtype}")
    if prob.dim() != 3 or min(prob.shape) < 1:
        raise ValueError(f"fb_smooth kernel takes an (M, h, w) stack with M, h, w >= 1, "
                         f"got {tuple(prob.shape)}")
    if not prob.is_contiguous():
        raise ValueError("fb_smooth kernel takes a contiguous stack")
    global fb_smooth_kernel_launches
    m, h, w = prob.shape
    mid = torch.empty_like(prob)
    out = torch.empty_like(prob)
    fn = _build.function("fb_smooth_launch", _ARGTYPES)
    with torch.cuda.device(prob.device):  # the launch goes to the current device
        err = fn(prob.data_ptr(), mid.data_ptr(), out.data_ptr(), m, h, w,
                 *_constants(s0_ems_prob, no_change_prob),
                 torch.cuda.current_stream(prob.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fb_smooth kernel launch failed: cudaError {err}")
    fb_smooth_kernel_launches += 1
    return out
