"""The pose sweep's P3P correspondence collect: the hand-written CUDA kernel
(``csrc/pose_collect.cu``) and its wrapper.

Counterpart of ``voldor_tpu/vo/pose_step.py``'s ``collect_p3p_instances``
(:37, the sequential sweep's traced collect) and
``collect_p3p_instances_obs`` (:290, the Jacobi sweep's collect from the
observed tracks), whose plain versions stay in ``vo/pose_step.py``.

``pose_collect`` picks the mode from its inputs: with ``obs_track`` the
obs collect of every frame below ``active``, else the traced collect of
target frame ``active`` along ``flows``. CPU tensors take the plain
version; CUDA tensors launch the kernel on torch's current stream (each
launch counted in ``pose_collect_launches`` and in the program's tracer
as ``pose.collect``) or raise. There is no fallback from one to the other,
and no host read: the pose rows are built on the device and the kernel
reads them there.

The kernel is built with the package's other kernels by ``ops/_build.py``.
"""

from __future__ import annotations

import ctypes

import torch

from voldor_tpu_torch.ops import _build
from voldor_tpu_torch.ops.cost import _check, _pose_rows
from voldor_tpu_torch.utils.profiling import count

MAX_N = 8  # window frames the kernel takes (COLLECT_MAX_N)
THREADS = 128  # a block's threads, as the chain trace's

# Launches of the CUDA kernel since the last reset (a plain int; the chip
# smoke test reads it to show the main path went through the kernel).
pose_collect_launches = 0


class _CollectParams(ctypes.Structure):
    _fields_ = [
        ("fx", ctypes.c_float), ("fy", ctypes.c_float),
        ("cx", ctypes.c_float), ("cy", ctypes.c_float),
        ("rig_thresh", ctypes.c_float), ("rig_sum_thresh", ctypes.c_float),
        ("min_depth", ctypes.c_float), ("max_depth", ctypes.c_float),
        ("use_rig_sum", ctypes.c_int), ("use_max_depth", ctypes.c_int),
        ("n_frames", ctypes.c_int), ("active", ctypes.c_int), ("lo", ctypes.c_int),
        ("stride", ctypes.c_int), ("h", ctypes.c_int), ("w", ctypes.c_int),
        ("hs", ctypes.c_int), ("ws", ctypes.c_int),
    ]


_ARGTYPES = [ctypes.c_void_p] * 12 + [
    ctypes.POINTER(_CollectParams), ctypes.c_int, ctypes.c_void_p]


def _plain(depth, rigidness, Rs, ts, active, p, flows, obs_track, obs_tinb, ckw):
    from voldor_tpu_torch.vo import pose_step  # the plain versions sit beside the sweeps

    if obs_track is not None:
        return pose_step.collect_p3p_instances_obs(
            depth, obs_track, obs_tinb, rigidness, Rs, ts, active, p, **ckw)
    return pose_step.collect_p3p_instances(depth, flows, rigidness, Rs, ts, active, p, **ckw)


def _plain_route(depth) -> bool:
    """CPU tensors take the plain version; every other device the kernel."""
    return depth.device.type == "cpu"


def _bind(depth, rigidness, Rs, ts, active, p, flows, obs_track, obs_tinb, *,
          rigidness_threshold, rigidness_sum_threshold, sample_min_depth, sample_max_depth,
          max_trace_on_flow, sample_stride=1):
    """Check the operands and allocate the outputs of one launch: (C
    function, its arguments, (p2, p3, valid), the pose rows the arguments
    point to)."""
    f32 = (torch.float32,)
    dev = depth.device
    obs = obs_track is not None
    if depth.dim() != 2 or rigidness.dim() != 3:
        raise ValueError(f"pose collect takes an (h, w) depth and (N, h, w) rigidness, got "
                         f"{tuple(depth.shape)} and {tuple(rigidness.shape)}")
    h, w = depth.shape
    N = rigidness.shape[0]
    if not 1 <= N <= MAX_N:
        raise ValueError(f"pose collect kernel takes 1..{MAX_N} window frames, got {N}")
    s = int(sample_stride)
    if s < 1:
        raise ValueError(f"pose collect takes a sample stride of 1 or more, got {s}")
    active = int(active)
    if not (0 <= active if obs else 0 <= active < N):
        raise ValueError(f"pose collect: frame {active} is outside the window of {N}")
    _check("depth", depth, (h, w), f32, dev)
    _check("rigidness", rigidness, (N, h, w), f32, dev)
    _check("Rs", Rs, (N, 3, 3), f32, dev, contiguous=False)
    _check("ts", ts, (N, 3), f32, dev, contiguous=False)
    if obs:
        for name, t in zip(("tx", "ty", "obx", "oby"), obs_track):
            _check(name, t, (N, h, w), f32, dev)
        _check("obs_tinb", obs_tinb, (N, h, w), (torch.bool,), dev)
    else:
        _check("flows", flows, (N, h, w, 2), f32, dev)
    if dev.type != "cuda":
        raise ValueError(f"pose collect kernel: unsupported device {dev}")
    if not obs and flows.data_ptr() % 8:
        raise ValueError("pose collect kernel reads the flows as float2: "
                         "they must start on 8 bytes")
    hs, ws = -(-h // s), -(-w // s)
    T = N if obs else 1
    p2 = torch.empty((T, hs, ws, 2), dtype=torch.float32, device=dev)
    p3 = torch.empty((T, hs, ws, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((T, hs, ws), dtype=torch.bool, device=dev)
    poses = _pose_rows(Rs, ts, N).contiguous()  # stays on the device

    M = int(max_trace_on_flow)
    prm = _CollectParams()
    prm.fx, prm.fy, prm.cx, prm.cy = p.fx, p.fy, p.cx, p.cy
    prm.rig_thresh, prm.rig_sum_thresh = rigidness_threshold, rigidness_sum_threshold
    prm.min_depth, prm.max_depth = sample_min_depth, sample_max_depth
    # the plain versions' host-side tests, decided here as they decide them
    prm.use_rig_sum = int(rigidness_sum_threshold > N + 1)
    prm.use_max_depth = int(not sample_max_depth <= 0)
    prm.n_frames, prm.active, prm.stride = N, active, s
    prm.lo = 0 if obs or M <= 0 else max(0, active - M + 1)
    prm.h, prm.w, prm.hs, prm.ws = h, w, hs, ws
    if obs:
        ins = (None, *(t.data_ptr() for t in obs_track), obs_tinb.data_ptr())
    else:
        ins = (flows.data_ptr(),) + (None,) * 5
    args = (poses.data_ptr(), depth.data_ptr(), rigidness.data_ptr(), *ins, p2.data_ptr(),
            p3.data_ptr(), valid.data_ptr(), ctypes.byref(prm), THREADS,
            torch.cuda.current_stream(dev).cuda_stream)
    out = (p2, p3, valid) if obs else (p2[0], p3[0], valid[0])
    return _build.function("pose_collect_launch", _ARGTYPES), args, out, poses


def pose_collect(depth, rigidness, Rs, ts, active: int, p, *, flows=None, obs_track=None,
                 obs_tinb=None, **ckw):
    """The P3P correspondences of a window: depth (h, w), rigidness (N, h,
    w), pose f (Rs[f], ts[f]) mapping frame-f points to frame f + 1; ``ckw``
    the collect's thresholds, ``max_trace_on_flow`` and ``sample_stride``
    (``pose_step._collect_kw``).

    * traced (``flows`` (N, h, w, 2)): target frame ``active``; returns
      p2 (hs, ws, 2), p3 (hs, ws, 3), valid (hs, ws), as
      ``pose_step.collect_p3p_instances``;
    * obs (``obs_track`` = (tx, ty, obx, oby), each (N, h, w), and
      ``obs_tinb`` (N, h, w) bool): every frame below ``active``; returns
      p2 (N, hs, ws, 2), p3 (N, hs, ws, 3), valid (N, hs, ws), as
      ``pose_step.collect_p3p_instances_obs``.

    CPU tensors take those plain versions; CUDA tensors (float32, the
    per-pixel planes contiguous, N <= ``MAX_N``) launch the kernel."""
    if _plain_route(depth):
        return _plain(depth, rigidness, Rs, ts, active, p, flows, obs_track, obs_tinb, ckw)
    out = _launch(depth, rigidness, Rs, ts, active, p, flows, obs_track, obs_tinb, ckw)
    global pose_collect_launches
    pose_collect_launches += 1
    count("pose.collect")
    return out


def _launch(depth, rigidness, Rs, ts, active, p, flows, obs_track, obs_tinb, ckw):
    """One kernel launch; returns its outputs."""
    fn, args, out, _poses = _bind(depth, rigidness, Rs, ts, active, p, flows, obs_track,
                                  obs_tinb, **ckw)
    with torch.cuda.device(depth.device):  # the launch goes to the current device
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"pose collect kernel launch failed: cudaError {err}")
    return out
