"""The VO EM solve over a mesh of devices (port of
``voldor_tpu/parallel/mesh.py``).

Two axes, as in the JAX package:

* sp (spatial): the image's rows. Each device of the axis launches the two
  hand-written kernels on its band of rows: the cost kernel scores and
  accepts every proposal batch of a depth round on its band
  (``ops/cost.py:cost_map_accept_bands``), and fb_smooth smooths the band's
  rows, then a band of columns of the gathered row pass
  (``ops/fb_smooth.py:fb_smooth_bands``). Flows, poses and tracks stay on
  the mesh's first device, where the proposals are built (propagation
  reads other rows) and the bands' results are gathered after every batch.
* hyp (hypotheses): the P4P pose hypotheses. They are drawn once on the
  first device; each device of the axis solves its slice
  (``vo/pose_step.py:_solve_and_fuse``, one P4P kernel launch a device on
  the card), and the pool is gathered on the first device. There the
  meanshift and robust-Gaussian kernels each run the whole search in one
  launch, as their plain versions do on CPU tensors: a mesh's pose fusion
  is a mesh of one's arithmetic.

On a 2-D sp x hyp mesh the sp axis runs over the devices of hyp index 0
and the hyp axis over those of sp index 0 (``Mesh.axis_devices``).

Where the JAX package lets GSPMD place the work, the hooks here are
explicit (``parallel/hints.py``), and each is the identity without an
active mesh: single-device runs are unchanged. Every random draw comes from
one ``torch.Generator`` on the mesh's first device, in the single-device
order, so a mesh's result differs from a mesh of one only in the order of
its reductions.

``make_mesh`` / ``make_mesh_2d`` take the first CUDA devices and raise when
fewer exist. Virtual shards, several on one device (the counterpart of the
JAX package's CPU test mesh), come only from an explicit list:
``make_mesh(4, devices=["cuda:0"] * 4)`` or ``devices=["cpu"] * 8``.
"""

from __future__ import annotations

import numpy as np
import torch

from voldor_tpu_torch.config import VoldorConfig
from voldor_tpu_torch.parallel.hints import active_mesh
from voldor_tpu_torch.vo import em
from voldor_tpu_torch.vo.engine import _depth_round_core, _solve_loop, depth_kw, pose_hp
from voldor_tpu_torch.vo.pose_step import optimize_camera_pose

_ROW_BLOCK = 8

# the keyword defaults of the JAX package's _pose_step_core
# (voldor_tpu/vo/pose_step.py:408-441), which multichip_em_step leaves as they are
_POSE_STEP_DEFAULTS = dict(
    rigidness_threshold=0.5, rigidness_sum_threshold=1.0, sample_min_depth=0.1,
    sample_max_depth=1000.0, max_trace_on_flow=3, pose_sample_stride=1,
    n_poses_to_sample=8192, meanshift_kernel_var=0.1, meanshift_rvec_scale=25.0,
    meanshift_epsilon=1e-5, meanshift_max_iters=100, meanshift_max_init_trials=20,
    meanshift_good_init_confidence=0.5, rg_trunc_sigma=3.0, rg_covar_reg_lambda=0.001,
    rg_pose_scaling=100.0, rg_epsilon=1e-5, rg_max_iters=100, minimal_solver="lambdatwist",
)


class Mesh:
    """Devices laid out on named axes: ``devices`` in row-major order over
    ``shape``. A device may appear more than once (virtual shards)."""

    def __init__(self, devices, axis_names, shape):
        self.devices = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        if len(self.devices) != int(np.prod(list(self.shape.values()))):
            raise ValueError(f"{len(self.devices)} devices do not fill a {tuple(shape)} mesh")

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis``, every other axis at index 0."""
        k = self.axis_names.index(axis)
        stride = int(np.prod([self.shape[a] for a in self.axis_names[k + 1:]], dtype=np.int64))
        return [self.devices[i * stride] for i in range(self.shape[axis])]

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def _take_devices(n: int, devices) -> list:
    if devices is not None:
        devices = list(devices)
        if len(devices) < n:
            raise ValueError(f"a mesh of {n} devices, but only {len(devices)} were given")
        return devices[:n]
    have = torch.cuda.device_count()
    if n > have:
        raise RuntimeError(
            f"a mesh of {n} CUDA devices was asked for, but {have} exist; pass devices=[...] "
            "for virtual shards (e.g. ['cuda:0'] * n)"
        )
    return [f"cuda:{i}" for i in range(n)]


def make_mesh(n_devices: int | None = None, axis: str = "sp", devices=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` of ``devices`` (default: the
    CUDA devices; all of them when ``n_devices`` is None)."""
    if n_devices is None:
        n_devices = len(devices) if devices is not None else torch.cuda.device_count()
        if n_devices < 1:
            raise RuntimeError("no CUDA device is available; pass devices=[...]")
    return Mesh(_take_devices(n_devices, devices), (axis,), (n_devices,))


def make_mesh_2d(n_sp: int, n_hyp: int, devices=None) -> Mesh:
    """2-D mesh: pixel rows over ``sp``, P4P hypotheses over ``hyp``."""
    return Mesh(_take_devices(n_sp * n_hyp, devices), ("sp", "hyp"), (n_sp, n_hyp))


def _put(x, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def shard_window(mesh: Mesh, flows, rigidness, depth):
    """The window's maps on the mesh's first device, where the sharded
    solve keeps them (each band is cut from them per round)."""
    dev = mesh.devices[0]
    return _put(flows, dev), _put(rigidness, dev), _put(depth, dev)


def multichip_solve(mesh: Mesh, cfg: VoldorConfig, flows, depth, poses6, seed=None):
    """The full EM solve (``engine._solve_loop``: camera sweeps with
    truncation, depth rounds, gauge normalisation) over a mesh: mono, no
    priors, from the given depth and poses (no bootstrap), as
    ``voldor_tpu/parallel/mesh.py:multichip_solve`` runs the JAX solve.

    The rows are padded up to a multiple of _ROW_BLOCK (doubled while
    smaller than the sp extent) with inert rows -- flow 0, depth 0 (below
    pose_sample_min_depth, so no padded pixel enters the P4P pool),
    rigidness 0 -- and every output is cropped back. The padding changes
    the index space the correspondences are drawn from, so it is kept on
    every mesh, a mesh of one included. Returns the solve's state dict
    (depth, rigidness, poses6, covars, ...) on the mesh's first device."""
    dev = mesh.devices[0]
    flows, depth = _put(flows, dev), _put(depth, dev)
    N, h, w = flows.shape[:3]
    sp_size = mesh.shape.get("sp", 1)
    block = _ROW_BLOCK
    while block < sp_size:
        block *= 2
    hp = -(-h // block) * block
    rigidness = torch.ones((N, h, w), dtype=torch.float32, device=dev)
    if hp != h:
        pad = hp - h
        flows = torch.nn.functional.pad(flows, (0, 0, 0, 0, 0, pad))
        depth = torch.nn.functional.pad(depth, (0, 0, 0, pad))
        rigidness = torch.nn.functional.pad(rigidness, (0, 0, 0, pad))

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(cfg.seed if seed is None else seed))
    z0 = torch.zeros((0, hp, w), dtype=torch.float32, device=dev)
    with active_mesh(mesh):
        st = _solve_loop(
            cfg, em.EmParams.from_config(cfg, False), pose_hp(cfg), depth_kw(cfg), gen,
            depth, flows, rigidness, z0, z0, z0, torch.zeros((0, 6), device=dev),
            _put(poses6, dev), torch.zeros((N, 6, 6), dtype=torch.float32, device=dev),
            torch.zeros(N, dtype=torch.float32, device=dev),
            torch.zeros(N, dtype=torch.int32, device=dev), N,
        )
    if hp != h:
        st = {k: _crop_rows(k, v, h) for k, v in st.items()}
    return st


# the row axis of each state entry that has one (the rest are per frame)
_ROW_DIM = dict(depth=0, rigidness=1, dp_confs=1, track=1, tinb=1)


def _crop_rows(key: str, v, h: int):
    """Crop the padded row axis of state entry ``key`` back to h rows (the
    JAX package guesses it as every axis of the padded size,
    ``mesh.py:142-151``; here each entry names its own, so a width equal to
    the padded row count stays whole). ``track`` is a tuple of planes."""
    dim = _ROW_DIM.get(key)
    if dim is None:
        return v
    if isinstance(v, tuple):
        return tuple(t.narrow(dim, 0, h) for t in v)
    return v.narrow(dim, 0, h)


def multichip_em_step(mesh: Mesh, cfg: VoldorConfig, flows, rigidness, depth, poses6):
    """One sharded EM step: the pose step of frame 0, then a depth round
    (``mesh.py:154-212``). flows (N, h, w, 2), rigidness (N, h, w), depth
    (h, w), as ``shard_window`` places them; poses6 (N, 6). The pose step
    draws from a generator seeded with cfg.seed, the depth round's
    uniforms from one seeded with cfg.seed + 1. Returns (poses6,
    pose_covars, depth, rigidness)."""
    flows, rigidness, depth = shard_window(mesh, flows, rigidness, depth)
    dev = mesh.devices[0]
    params = em.EmParams.from_config(cfg, has_disparity=False)
    N, h, w = flows.shape[:3]
    covars = torch.zeros((N, 6, 6), dtype=torch.float32, device=dev)
    poses6 = _put(poses6, dev)
    hp = dict(_POSE_STEP_DEFAULTS, n_poses_to_sample=cfg.n_poses_to_sample)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(cfg.seed) + 1)
    z0 = torch.zeros((0, h, w), dtype=torch.float32, device=dev)
    with active_mesh(mesh):
        res = optimize_camera_pose(
            depth, flows, rigidness, poses6, covars, 0, False, True, int(cfg.seed), params, **hp
        )
        u = em.draw_depth_uniforms(gen, cfg.depth_rand_samples, h, w, dev)
        depth, rigidness, _ = _depth_round_core(
            depth, flows, rigidness, res.poses6, z0, z0, z0, torch.zeros((0, 6), device=dev), N,
            params, u, cfg.fb_emm, cfg.fb_no_change_prob, cfg.depth_range_factor,
            gstep=cfg.depth_global_prop_step, lwidth=cfg.depth_local_prop_width,
            mode=cfg.depth_local_prop_mode, fb=bool(cfg.fb_smooth), rig_only=False,
            use_flows=True, use_priors=False,
            tracked=cfg.depth_cost_mode in ("tracked", "anchored"),
        )
    return res.poses6, res.pose_covars, depth, rigidness
