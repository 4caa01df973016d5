"""HMM forward-backward smoothing of rigidness maps
(port of ``voldor_tpu/ops/fb_smooth.py``): the hand-written CUDA kernel
(``csrc/fb_smooth_kernel.cu``), its wrapper, its plain versions and the
log-depth library variant.

A 2-state HMM smooths each map along rows, then along columns: forward and
backward message passes, then a pointwise posterior. Each line step is the
recurrence prev' = s1 / (s0 + s1), a Moebius map of prev; Moebius maps
compose by 2x2 products, so a line can be evaluated by a scan.

* ``fb_smooth`` — the wrapper. For CUDA tensors it launches the kernel (a
  row launch and a column launch, counted once in
  ``fb_smooth_kernel_launches``); for CPU tensors it calls the plain
  version. There is no fallback from one to the other.
* ``fb_smooth_reference`` — the plain version (:134's serial recurrences):
  each line step is a handful of elementwise ops over all lines at once,
  so one call is about 2 * (h + w) sequential steps.
* ``fb_smooth_chunked_reference`` — the kernel's arithmetic in plain torch,
  op for op: each line cut into chunks, each chunk's maps composed, a
  doubling scan over the chunks for the carry-in messages, then the serial
  steps within each chunk. For the tests and chip_smoke.py.
* ``fb_smooth_assoc`` — :112's log-depth variant: the whole line scanned by
  Hillis-Steele doubling over its maps. Plain torch on every device; a
  library function, as in the JAX package (no config switch selects it).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from voldor_tpu_torch.ops import _build

# Calls that launched the CUDA kernel since the last reset (plain int; the
# chip smoke test reads it to show the main path went through the kernel).
fb_smooth_kernel_launches = 0

# The kernel's chunks per line, rows and columns alike: one warp's lanes.
CHUNKS = 32
N_CONSTS = 7
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
             + [ctypes.POINTER(ctypes.c_float), ctypes.c_void_p])


def _constants(s0_ems_prob, no_change_prob):
    """The HMM's constants as the kernel's struct Hmm orders them: e0, ncp,
    1 - ncp, 2 ncp - 1, 1 - 2 ncp, e0 ncp, (1 - ncp) e0, each rounded to f32
    in the JAX package's operation order."""
    f = np.float32
    e0, ncp = f(s0_ems_prob), f(no_change_prob)
    two_ncp = f(2.0) * ncp
    vals = (e0, ncp, f(1.0) - ncp, two_ncp - f(1.0), f(1.0) - two_ncp, e0 * ncp,
            (f(1.0) - ncp) * e0)
    return tuple(float(v) for v in vals)


@functools.lru_cache(maxsize=None)
def _constants_array(s0_ems_prob, no_change_prob):
    """_constants as the float[7] the kernel's entry point reads."""
    return (ctypes.c_float * N_CONSTS)(*_constants(s0_ems_prob, no_change_prob))


def _posterior(fwd, bwd):
    s1 = fwd * bwd
    s0 = (1.0 - fwd) * (1.0 - bwd)
    return s1 / torch.clamp_min(s0 + s1, 1e-30)


def _fwd_step(prev, e1, c):
    s0 = (prev * c[2] + (1.0 - prev) * c[1]) * c[0]
    s1 = (prev * c[1] + (1.0 - prev) * c[2]) * e1
    return s1 / (s0 + s1)


def _bwd_step(prev, e1, c):
    s0 = prev * e1 * c[2] + (1.0 - prev) * c[1] * c[0]
    s1 = prev * e1 * c[1] + (1.0 - prev) * c[2] * c[0]
    return s1 / (s0 + s1)


# A Moebius map x -> (a x + b) / (c x + d) is the 4-tuple (a, b, c, d) of
# same-shaped tensors.

def _forward_coeffs(e1, c):
    """The forward step at emission e1 as a map (fb_smooth.py:52)."""
    return e1 * c[3], e1 * c[2], (c[0] - e1) * c[4], c[5] + e1 * c[2]


def _backward_coeffs(e1, c):
    """The backward step at emission e1 as a map (fb_smooth.py:68)."""
    return e1 * c[1] - c[6], torch.full_like(e1, c[6]), e1 - c[0], torch.full_like(e1, c[0])


def _mobius_combine(earlier, later):
    """Apply ``earlier`` first, then ``later``: the product later @ earlier,
    scaled by the reciprocal of its largest |entry| (at least 1e-30), entries
    below 1e-12 flushed to zero (fb_smooth.py:29, which divides each entry
    by the largest: a Moebius map does not change under scaling, so either
    only bounds the range; one division and four products cost the kernel
    less than four divisions)."""
    ea, eb, ec, ed = earlier
    la, lb, lc, ld = later
    m = (la * ea + lb * ec, la * eb + lb * ed, lc * ea + ld * ec, lc * eb + ld * ed)
    s = torch.maximum(torch.maximum(torch.maximum(m[0].abs(), m[1].abs()), m[2].abs()), m[3].abs())
    r = torch.reciprocal(torch.clamp_min(s, 1e-30))
    return tuple(torch.where(q.abs() < 1e-12, 0.0, q) for q in (v * r for v in m))


def _apply_mobius(m, x):
    """(fb_smooth.py:46)"""
    num = m[0] * x + m[1]
    den = m[2] * x + m[3]
    return num / torch.where(den.abs() < 1e-30, 1e-30, den)


def _line(prob, c):
    """Smooth along the last axis of ``prob`` (any leading dims), serially."""
    n = prob.shape[-1]
    fwd = torch.empty_like(prob)
    bwd = torch.empty_like(prob)
    prev = prob[..., 0]
    for i in range(n):
        prev = _fwd_step(prev, prob[..., i], c)
        fwd[..., i] = prev
    prev = prob[..., n - 1]
    for i in range(n - 1, -1, -1):
        prev = _bwd_step(prev, prob[..., i], c)
        bwd[..., i] = prev
    return _posterior(fwd, bwd)


def _rows_then_cols(line, prob, *args):
    prob = line(prob, *args)
    return line(prob.transpose(-1, -2), *args).transpose(-1, -2).contiguous()


def fb_smooth_reference(prob: torch.Tensor, s0_ems_prob: float, no_change_prob: float) -> torch.Tensor:
    """Plain version: smooth a (..., h, w) stack of probability maps, rows
    then columns."""
    return _rows_then_cols(_line, prob, _constants(s0_ems_prob, no_change_prob))


def _line_pass(prob, c, backward: bool):
    """One message pass along the last axis, as one Hillis-Steele doubling
    scan of the line's maps (fb_smooth.py:86)."""
    if backward:
        prob = torch.flip(prob, (-1,))
    m = (_backward_coeffs if backward else _forward_coeffs)(prob, c)
    n = prob.shape[-1]
    k = 1
    while k < n:
        new = _mobius_combine(tuple(v[..., :-k] for v in m), tuple(v[..., k:] for v in m))
        m = tuple(torch.cat([v[..., :k], w], -1) for v, w in zip(m, new))
        k *= 2
    msg = _apply_mobius(m, prob[..., :1])
    return torch.flip(msg, (-1,)) if backward else msg


def _assoc_line(prob, c):
    return _posterior(_line_pass(prob, c, False), _line_pass(prob, c, True))


def fb_smooth_assoc(prob: torch.Tensor, s0_ems_prob: float, no_change_prob: float) -> torch.Tensor:
    """Log-depth fb_smooth (fb_smooth.py:112): every line's messages from a
    doubling scan of its Moebius maps, rows then columns."""
    return _rows_then_cols(_assoc_line, prob, _constants(s0_ems_prob, no_change_prob))


def _chunked_line(prob, c, chunks):
    """The kernel's smooth_line over the last axis, all lines at once."""
    n = prob.shape[-1]
    L = math.ceil(n / chunks)
    x = torch.nn.functional.pad(prob, (0, chunks * L - n)).unflatten(-1, (chunks, L))
    real = (torch.arange(chunks * L, device=prob.device) < n).reshape(chunks, L)
    eye = (1.0, 0.0, 0.0, 1.0)

    def maps(coeffs):  # padded positions are identity maps
        return tuple(torch.where(real, v, i) for v, i in zip(coeffs(x, c), eye))

    fm, bm = maps(_forward_coeffs), maps(_backward_coeffs)
    F = tuple(v[..., 0] for v in fm)
    B = tuple(v[..., L - 1] for v in bm)
    for k in range(1, L):
        F = _mobius_combine(F, tuple(v[..., k] for v in fm))
        B = _mobius_combine(B, tuple(v[..., L - 1 - k] for v in bm))
    k = 1
    while k < chunks:  # the warp's shuffle scans, both directions
        nf = _mobius_combine(tuple(v[..., :-k] for v in F), tuple(v[..., k:] for v in F))
        nb = _mobius_combine(tuple(v[..., k:] for v in B), tuple(v[..., :-k] for v in B))
        F = tuple(torch.cat([v[..., :k], w], -1) for v, w in zip(F, nf))
        B = tuple(torch.cat([w, v[..., -k:]], -1) for v, w in zip(B, nb))
        k *= 2
    init_f, init_b = prob[..., :1], prob[..., n - 1:]
    pf = torch.cat([init_f, _apply_mobius(F, init_f)[..., :-1]], -1)
    pb = torch.cat([_apply_mobius(B, init_b)[..., 1:], init_b], -1)
    fwd = torch.empty_like(x)
    bwd = torch.empty_like(x)
    for k in range(L):
        pf = torch.where(real[:, k], _fwd_step(pf, x[..., k], c), pf)
        fwd[..., k] = pf
        kb = L - 1 - k
        pb = torch.where(real[:, kb], _bwd_step(pb, x[..., kb], c), pb)
        bwd[..., kb] = pb
    return _posterior(fwd, bwd).flatten(-2)[..., :n]


def fb_smooth_chunked_reference(prob: torch.Tensor, s0_ems_prob: float, no_change_prob: float,
                                chunks: int | None = None) -> torch.Tensor:
    """The kernel's chunked arithmetic in plain torch: rows then columns,
    each line cut into ``chunks`` chunks of ceil(n / chunks); by default the
    kernel's CHUNKS, with which it rounds as the kernel does."""
    return _rows_then_cols(_chunked_line, prob, _constants(s0_ems_prob, no_change_prob),
                           CHUNKS if chunks is None else chunks)


def _check_stack(prob: torch.Tensor, what: str):
    if prob.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {prob.device}")
    if prob.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes float32, got {prob.dtype}")
    if prob.dim() != 3 or min(prob.shape) < 1:
        raise ValueError(f"{what} kernel takes an (M, h, w) stack with M, h, w >= 1, "
                         f"got {tuple(prob.shape)}")
    if not prob.is_contiguous():
        raise ValueError(f"{what} kernel takes a contiguous stack")


def fb_smooth(prob: torch.Tensor, s0_ems_prob: float, no_change_prob: float,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """Smooth a stack of probability maps, rows then columns, into ``out``
    (a new tensor if None). CPU tensors take the plain version; a CUDA
    tensor must be a contiguous (M, h, w) float32 stack with M >= 1, and
    launches the kernel, which writes into ``out`` (contiguous, same shape,
    dtype and device) directly."""
    if prob.device.type == "cpu":
        ref = fb_smooth_reference(prob, s0_ems_prob, no_change_prob)
        return ref if out is None else out.copy_(ref)
    _check_stack(prob, "fb_smooth")
    if out is None:
        out = torch.empty_like(prob)
    elif (out.shape != prob.shape or out.dtype != prob.dtype or out.device != prob.device
          or not out.is_contiguous()):
        raise ValueError("fb_smooth: out must be a contiguous tensor of the input's shape, "
                         "dtype and device")
    global fb_smooth_kernel_launches
    m, h, w = prob.shape
    mid = torch.empty_like(prob)
    consts = _constants_array(float(s0_ems_prob), float(no_change_prob))
    fn = _build.function("fb_smooth_launch", _ARGTYPES)
    with torch.cuda.device(prob.device):  # the launch goes to the current device
        err = fn(prob.data_ptr(), mid.data_ptr(), out.data_ptr(), m, h, w, consts,
                 torch.cuda.current_stream(prob.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fb_smooth kernel launch failed: cudaError {err}")
    fb_smooth_kernel_launches += 1
    return out

