"""The chain trace of a depth map through the window: the hand-written CUDA
kernel (``csrc/chain_trace.cu``), its wrapper and its plain version.

Counterpart of ``voldor_tpu/vo/em.py``'s ``chain_flow_terms`` (:95) and of
the rigidness refresh built on it, ``update_rigidness`` (:325) and
``update_rigidness_and_tracks`` (:332).

* ``chain_trace`` — the wrapper: the per-frame rigidness, the in-bounds
  mask and, with ``tracks``, the anchored track planes. For CUDA tensors it
  launches the kernel on torch's current stream (each launch counted in
  ``chain_trace_launches`` and in the program's tracer as
  ``em.chain_trace``); for CPU tensors it composes the plain version,
  ``chain_flow_terms`` -> ``fisk.rigidness_xy`` -> ``where``. There is no
  fallback from one to the other, and no host read: the pose rows are
  built on the device and the kernel reads them there.
* ``chain_flow_terms`` — the plain walk of every frame-0 point through the
  window (also the projected cost's, ``em.compute_cost_map``).

The kernel is built with the package's other kernels by ``ops/_build.py``.
"""

from __future__ import annotations

import ctypes

import torch

from voldor_tpu_torch.ops import _build, fisk
from voldor_tpu_torch.ops.cost import _check, _pose_rows
from voldor_tpu_torch.ops.image import bilinear_sample
from voldor_tpu_torch.utils.profiling import count

MAX_N = 8  # window frames the kernel takes (CHAIN_MAX_N)
THREADS = 128  # a block's threads: 7% faster than 256 on an H100 (PERF.md)

# Launches of the CUDA kernel since the last reset (a plain int; the chip
# smoke test reads it to show the main path went through the kernel).
chain_trace_launches = 0


class _ChainParams(ctypes.Structure):
    _fields_ = [
        ("fx", ctypes.c_float), ("fy", ctypes.c_float),
        ("cx", ctypes.c_float), ("cy", ctypes.c_float),
        ("lam", ctypes.c_float), ("arf", ctypes.c_float),
        ("n_frames", ctypes.c_int), ("active_n", ctypes.c_int),
        ("h", ctypes.c_int), ("w", ctypes.c_int),
    ]


_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.POINTER(_ChainParams), ctypes.c_int, ctypes.c_void_p]


def _backproject(xs, ys, depth, p):
    ox = fisk.div_scalar(xs - p.cx, p.fx) * depth
    oy = fisk.div_scalar(ys - p.cy, p.fy) * depth
    return ox, oy, depth


def _pixel_grid(h, w, device, dtype=torch.float32):
    ys, xs = torch.meshgrid(
        torch.arange(h, device=device), torch.arange(w, device=device), indexing="ij"
    )
    return xs.to(dtype), ys.to(dtype)


def _transform(R, t, ox, oy, oz):
    nx = R[0, 0] * ox + R[0, 1] * oy + R[0, 2] * oz + t[0]
    ny = R[1, 0] * ox + R[1, 1] * oy + R[1, 2] * oz + t[1]
    nz = R[2, 0] * ox + R[2, 1] * oy + R[2, 2] * oz + t[2]
    return nx, ny, nz


def _project_safe(nx, ny, nz, p):
    safe_nz = torch.where(torch.abs(nz) < 1e-12, 1e-12, nz)
    px = (p.fx * nx + p.cx * safe_nz) / safe_nz
    py = (p.fy * ny + p.cy * safe_nz) / safe_nz
    return px, py


def chain_flow_terms(depth, flows, Rs, ts, active_n: int, p):
    """Walk each frame-0 point through the window.

    Returns (rigid_x, rigid_y, obs_x, obs_y, inb, px1, py1), each (N, h, w):
    rigid flow, observed flow sampled at the traced position, in-bounds
    mask and the traced position itself (``em.py:95``).
    """
    h, w = depth.shape
    N = flows.shape[0]
    xs, ys = _pixel_grid(h, w, depth.device)
    ox, oy, oz = _backproject(xs, ys, depth, p)
    px1, py1 = xs, ys
    outs = []
    for f in range(N):
        active = f < active_n
        nx, ny, nz = _transform(Rs[f], ts[f], ox, oy, oz)
        px2, py2 = _project_safe(nx, ny, nz, p)
        inb = (nz > 0) & (px1 >= 0) & (px1 < w) & (py1 >= 0) & (py1 < h) & active
        if active:
            obs = bilinear_sample(flows[f], px1, py1)
            obx, oby = obs[..., 0], obs[..., 1]
        else:
            obx = oby = torch.zeros_like(px1)
        outs.append((px2 - px1, py2 - py1, obx, oby, inb, px1, py1))
        px1 = torch.where(inb, px2, px1)
        py1 = torch.where(inb, py2, py1)
        ox, oy, oz = nx, ny, nz
    return tuple(torch.stack(c) for c in zip(*outs))


def chain_trace_reference(depth, flows, Rs, ts, active_n: int, p, tracks: bool = True):
    """Plain PyTorch version of ``chain_trace``, on any device."""
    rx, ry, obx, oby, inb, px1, py1 = chain_flow_terms(depth, flows, Rs, ts, active_n, p)
    r = fisk.rigidness_xy(rx, ry, obx, oby, p.lam, p.abs_resize_factor)
    return torch.where(inb, r, 0.0), inb, ((px1, py1, obx, oby) if tracks else None)


def _bind(depth, flows, Rs, ts, active_n, p, tracks):
    """Check the operands and allocate the outputs of one launch: (C
    function, its arguments, (rigidness, inb, track or None), the pose rows
    the arguments point to)."""
    f32 = (torch.float32,)
    dev = depth.device
    if depth.dim() != 2 or flows.dim() != 4:
        raise ValueError(f"chain trace takes an (h, w) depth and (N, h, w, 2) flows, got "
                         f"{tuple(depth.shape)} and {tuple(flows.shape)}")
    h, w = depth.shape
    N = flows.shape[0]
    if not 1 <= N <= MAX_N:
        raise ValueError(f"chain trace kernel takes 1..{MAX_N} window frames, got {N}")
    _check("depth", depth, (h, w), f32, dev)
    _check("flows", flows, (N, h, w, 2), f32, dev)
    _check("Rs", Rs, (N, 3, 3), f32, dev, contiguous=False)
    _check("ts", ts, (N, 3), f32, dev, contiguous=False)
    if dev.type != "cuda":
        raise ValueError(f"chain trace kernel: unsupported device {dev}")
    if flows.data_ptr() % 8:
        raise ValueError("chain trace kernel reads the flows as float2: they must start on 8 bytes")
    rig = torch.empty((N, h, w), dtype=torch.float32, device=dev)
    inb = torch.empty((N, h, w), dtype=torch.bool, device=dev)
    track = None
    if tracks:
        track = tuple(torch.empty((4, N, h, w), dtype=torch.float32, device=dev).unbind(0))
    poses = _pose_rows(Rs, ts, N).contiguous()  # stays on the device

    prm = _ChainParams()
    prm.fx, prm.fy, prm.cx, prm.cy = p.fx, p.fy, p.cx, p.cy
    prm.lam, prm.arf = p.lam, p.abs_resize_factor
    prm.n_frames, prm.active_n, prm.h, prm.w = N, int(active_n), h, w
    tp = (None,) * 4 if track is None else tuple(t.data_ptr() for t in track)
    args = (poses.data_ptr(), depth.data_ptr(), flows.data_ptr(), rig.data_ptr(),
            inb.data_ptr(), *tp, ctypes.byref(prm), THREADS,
            torch.cuda.current_stream(dev).cuda_stream)
    return _build.function("chain_trace_launch", _ARGTYPES), args, (rig, inb, track), poses


def chain_trace(depth, flows, Rs, ts, active_n: int, p, tracks: bool = True):
    """The chain trace of ``depth`` (h, w) through the window: flows (N, h,
    w, 2), pose f (Rs[f], ts[f]) mapping frame-f points to frame f + 1,
    frames f < ``active_n`` traced. Returns (rigidness (N, h, w), inb (N, h,
    w) bool, track), track = (px1, py1, obx, oby), each (N, h, w): the
    traced position at which frame f's flow was sampled and the observed
    flow there; None without ``tracks``. CPU tensors take the plain
    version; CUDA tensors (float32, depth and flows contiguous, N <=
    ``MAX_N``) launch the kernel."""
    if depth.device.type == "cpu":
        return chain_trace_reference(depth, flows, Rs, ts, active_n, p, tracks)
    fn, args, out, _poses = _bind(depth, flows, Rs, ts, active_n, p, tracks)
    with torch.cuda.device(depth.device):  # the launch goes to the current device
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"chain trace kernel launch failed: cudaError {err}")
    global chain_trace_launches
    chain_trace_launches += 1
    count("em.chain_trace")
    return out
