"""The seams where the benchmark's spans (benchmark/layers.py) and
chip_smoke.py wrap the VO engine, on the CPU.

Both wrap module attributes that the program looks up at call time: the
engine's cost calls, depth round and pose sweeps, and the pose step's
fuse and its two searches. One small stereo window is solved with each of
those names replaced by a recorder. Every name must be called, and the
calls whose arguments the benchmark reads by position must keep their
layout: the candidates (K, h, w) at args[0] of a score and args[2] of an
accept, then ``active_n`` an int with the ``EmParams`` and the prior
samples after it; ``valid`` (B, M) and the pose hyper-parameters at
args[2] and args[8] of the fuse; ``.iters`` on the meanshift and refit
results. The cost calls' per-pixel operands must be contiguous, as the
kernel takes them on the card.
"""

import collections

import numpy as np
import pytest
import torch

from synthetic import plane_depth, render_window
from voldor_tpu_torch.ops import lie
from voldor_tpu_torch.vo import engine, pose_step
from voldor_tpu_torch.vo.api import voldor
from voldor_tpu_torch.vo.em import EmParams

H, W, N = 40, 56, 5
FX = FY = 48.0
PLANES = [
    (np.array([0.1, 0.15, 1.0]) / np.linalg.norm([0.1, 0.15, 1.0]), 8.0),
    (np.array([-0.45, 0.1, 1.0]) / np.linalg.norm([-0.45, 0.1, 1.0]), 6.5),
    (np.array([0.3, -0.45, 1.0]) / np.linalg.norm([0.3, -0.45, 1.0]), 7.0),
]
# the hybrid sweep runs the sequential core at iteration 1, the Jacobi
# core after it
CONFIG = "--n_poses_to_sample 512 --depth_rand_samples 4 --pose_window_sweep hybrid"

SEAMS = {
    "cost_map_score": engine,
    "cost_map_accept": engine,
    "_depth_round_core": engine,
    "_cameras_window_core": engine,
    "_cameras_window_jacobi_core": engine,
    "_solve_and_fuse": pose_step,
    "meanshift": pose_step,
    "fit_robust_gaussian": pose_step,
}


@pytest.fixture(scope="module")
def calls():
    """One stereo window solved on the CPU with every seam recording its
    calls: name -> [(args, kwargs, result), ...]."""
    rng = np.random.default_rng(5)
    poses = np.zeros((N, 6), np.float32)
    for f in range(N):
        poses[f, :3] = rng.normal(0, 0.008, 3)
        poses[f, 3:6] = [0.45 + 0.03 * rng.normal(), 0.03 * rng.normal(), 0.18]
    K = np.array([[FX, 0, W / 2], [0, FY, H / 2], [0, 0, 1]], np.float32)

    def r2R(rv):
        return lie.so3_exp(torch.as_tensor(np.asarray(rv, np.float32))).numpy()

    flows, _, Ts = render_window(K, poses, PLANES, H, W, r2R)
    bf = 0.5 * FX
    disp = (bf / plane_depth(K, Ts[0][:3, :3], Ts[0][:3, 3], PLANES, H, W)).astype(np.float32)

    seen = collections.defaultdict(list)

    def recorder(name, fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen[name].append((args, kwargs, out))
            return out
        return wrapper

    with pytest.MonkeyPatch.context() as mp:
        for name, mod in SEAMS.items():
            mp.setattr(mod, name, recorder(name, getattr(mod, name)))
        voldor(flows, FX, FY, W / 2, H / 2, basefocal=bf, disparity=disp, config=CONFIG,
               device="cpu")
    return seen


def _check_cost_call(args, kwargs, accept):
    # score: (cands, track, tinb, rig, Rs, ts, active_n, p, ...); accept:
    # (depth, cost, cands, masks, track, tinb, rig, Rs, ts, active_n, p, ...)
    k, a = (2, 9) if accept else (0, 6)
    cands = args[k]
    assert isinstance(cands, torch.Tensor) and cands.dim() == 3
    assert tuple(cands.shape[1:]) == (H, W) and 1 <= cands.shape[0]
    active_n, p = args[a], args[a + 1]
    assert isinstance(active_n, int) and 1 <= active_n <= N
    assert isinstance(p, EmParams)
    ps = args[a + 2] if len(args) > a + 2 else kwargs.get("prior_samples")
    # the per-pixel operands, which the kernel takes only contiguous
    # (ops/cost.py:_bind)
    maps = [cands, *args[a - 5], args[a - 4], args[a - 3]]
    if ps is not None:  # (target (D, h, w), weight (D, h, w), Rs, ts)
        assert len(ps) == 4 and tuple(ps[0].shape[1:]) == (H, W)
        maps += ps[:2]
    if accept:
        depth, cost, masks = args[0], args[1], args[3]
        assert depth.shape == cost.shape == (H, W)
        maps += [depth, cost] + ([] if masks is None else [masks])
    assert all(m.is_contiguous() for m in maps)


@pytest.mark.parametrize("name", list(SEAMS))
def test_engine_seam_is_called_with_its_layout(calls, name):
    assert calls[name], f"{name} was never called through its module attribute"
    for args, kwargs, out in calls[name]:
        if name in ("cost_map_score", "cost_map_accept"):
            _check_cost_call(args, kwargs, name == "cost_map_accept")
        elif name == "_solve_and_fuse":
            valid, hp = args[2], args[8]
            assert valid.dim() == 2 and valid.dtype == torch.bool
            assert args[0].shape[:2] == valid.shape
            assert isinstance(args[5], bool)
            assert int(hp["n_poses_to_sample"]) == 512
        elif name in ("meanshift", "fit_robust_gaussian"):
            assert out.iters.shape[0] >= 1
