"""The port's multi-device solve (voldor_tpu_torch/parallel) on virtual CPU
meshes, against a mesh of one, as tests/test_multichip.py holds the JAX
package's sharded solve against one device.

Virtual shards are explicit device lists (``devices=["cpu"] * 8``), the
counterpart of the JAX package's 8-device CPU mesh. On CPU tensors the
kernels' plain versions run, band by band. Tolerances are the JAX tests'
(test_multichip.py:63-68, :121-126); the readings measured here are in the
docstrings. Banded plain kernels agree with the whole map to an ulp (the
CPU's vector and scalar math paths fall on different elements of a band);
the hyp axis solves slices of the hypotheses and gathers the pool for one
search, the mesh of one's arithmetic.
"""

import numpy as np
import pytest
import torch

from synthetic import render_window
from voldor_tpu_torch.config import VoldorConfig
from voldor_tpu_torch.ops import cost as tcost
from voldor_tpu_torch.ops import fb_smooth as tfb
from voldor_tpu_torch.ops import lie
from voldor_tpu_torch.parallel import hints
from voldor_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, make_mesh_2d, multichip_em_step, multichip_solve, shard_window,
)
from voldor_tpu_torch.vo import em
from voldor_tpu_torch.vo.engine import VoldorEngine

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel
    processes, and every process's default thread pool at once
    oversubscribes the cores (as tests/test_torch_refexact.py's)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _n(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def _r2R(rv):
    return lie.so3_exp(torch.as_tensor(np.asarray(rv, np.float32))).numpy()


def _consistent_window(n=3, h=32, w=128, focal=40.0, planes=None):
    """test_multichip.py's geometrically consistent two-plane window."""
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)
    planes = planes or [(_n([0.1, 0.15, 1.0]), 8.0), (_n([-0.35, 0.1, 1.0]), 6.5)]
    rng = np.random.default_rng(5)
    poses = np.zeros((n, 6), np.float32)
    for f in range(n):
        poses[f, :3] = rng.normal(0, 0.004, 3)
        poses[f, 3:6] = [0.1, 0.01, 0.3]
    flows, depth0, _ = render_window(K, poses, planes, h, w, _r2R)
    return flows, depth0


def _tiny_window(n=3, h=32, w=128):
    """__graft_entry__._tiny_window: smooth flows and a plausible depth."""
    rng = np.random.default_rng(0)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    flows = np.stack([
        np.stack([3.0 + 0.01 * xs + 0.2 * rng.standard_normal((h, w)).astype(np.float32),
                  0.5 + 0.01 * ys], axis=-1)
        for _ in range(n)
    ]).astype(np.float32)
    depth = (6.0 + 2.0 * rng.random((h, w))).astype(np.float32)
    return flows, depth


def _cfg(h, w, focal=40.0, max_iters=None):
    cfg = VoldorConfig(fx=focal, fy=focal, cx=w / 2, cy=h / 2, basefocal=focal / 2)
    cfg.n_poses_to_sample = 512
    cfg.depth_rand_samples = 2
    cfg.depth_local_prop_width = 8
    if max_iters is not None:
        cfg.max_iters = max_iters
    return cfg


def _poses0(n):
    p = np.zeros((n, 6), np.float32)
    p[:, 5] = 0.3
    return p


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-3)


MESHES = {
    "sp8": lambda: make_mesh(8, devices=[CPU] * 8),
    "sp4": lambda: make_mesh(4, devices=[CPU] * 4),
    "sp4xhyp2": lambda: make_mesh_2d(4, 2, devices=[CPU] * 8),
    "sp2xhyp2": lambda: make_mesh_2d(2, 2, devices=[CPU] * 4),
}


# --------------------------------------------------------------------------
# meshes and hooks
# --------------------------------------------------------------------------


def test_make_mesh_layout_and_limits():
    m = make_mesh_2d(2, 3, devices=[f"cpu:{i}" for i in range(6)])
    assert m.shape == {"sp": 2, "hyp": 3} and len(m.devices) == 6
    assert [d.index for d in m.axis_devices("sp")] == [0, 3]
    assert [d.index for d in m.axis_devices("hyp")] == [0, 1, 2]
    assert len(make_mesh(2, devices=[CPU] * 4).devices) == 2
    # more cards than exist: raises, never folds shards onto one card
    with pytest.raises(RuntimeError):
        make_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(RuntimeError):
        make_mesh_2d(torch.cuda.device_count() + 1, 1)
    with pytest.raises(ValueError):
        make_mesh(4, devices=[CPU] * 3)
    with pytest.raises(ValueError):
        Mesh([CPU] * 3, ("sp", "hyp"), (2, 2))


def test_hooks_are_identity_without_a_mesh_axis():
    assert hints.axis_devices("sp") is None and hints.axis_devices("hyp") is None
    with hints.active_mesh(make_mesh(4, axis="other", devices=[CPU] * 4)):
        assert hints.axis_devices("sp") is None and hints.axis_devices("other") is not None
    with hints.active_mesh(make_mesh(1, devices=[CPU])):
        assert hints.axis_devices("sp") is None  # one device spans the axis
    with hints.active_mesh(make_mesh_2d(2, 2, devices=[CPU] * 4)):
        assert len(hints.axis_devices("sp")) == 2 and len(hints.axis_devices("hyp")) == 2
    assert hints.axis_devices("sp") is None
    assert hints.bounds(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]


def test_engine_solve_unchanged_by_meshes_without_its_axes():
    """The engine's solve under a mesh of one, and under a mesh whose only
    axis the hooks do not know, is bitwise the solve with no mesh."""
    flows, _ = _consistent_window(n=3, h=24, w=64)
    outs = []
    for mesh in (None, make_mesh(1, devices=[CPU]), make_mesh(4, axis="other", devices=[CPU] * 4)):
        eng = VoldorEngine(_cfg(24, 64, max_iters=2), device=CPU).init(flows)
        if mesh is None:
            eng.solve()
        else:
            with hints.active_mesh(mesh):
                eng.solve()
        outs.append((eng.poses6, eng.pose_covars, eng.depth, eng.rigidness))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the kernels' band logic, plain versions
# --------------------------------------------------------------------------


def _cost_inputs(h=29, w=40, n=3, k=4, seed=1):
    flows, depth = _tiny_window(n, h, w)
    cfg = _cfg(h, w)
    p = em.EmParams.from_config(cfg, False)
    f, d = torch.as_tensor(flows), torch.as_tensor(depth)
    track, tinb = em.precompute_obs_tracks(f, n, p)
    rng = np.random.default_rng(seed)
    rig = torch.as_tensor(rng.uniform(0.2, 1.0, (n, h, w)).astype(np.float32))
    poses = torch.as_tensor(_poses0(n))
    Rs, ts = lie.so3_exp(poses[:, :3]), poses[:, 3:6]
    cands = torch.as_tensor((d.numpy() * rng.uniform(0.7, 1.3, (k, h, w))).astype(np.float32))
    masks = torch.as_tensor(rng.uniform(size=(k, h, w)) < 0.7)
    return d, cands, masks, (track, tinb, rig, Rs, ts), p


@pytest.mark.parametrize("n_bands", [2, 3, 4])
def test_band_cost_equals_whole_map(n_bands):
    """Score and accept over row bands (each band's planes a contiguous
    copy, its first image row passed as y0) against the whole-map plain
    versions: scores within rtol 1e-6 (torch's CPU log / pow / exp take a
    vector path over most of a tensor and a scalar path over its tail, so a
    band can round an element 1 ulp apart: measured 9.9e-8 relative, 1
    element of 4640); the accepted depth equal at >= 99.9% of pixels (a
    1-ulp near-tie may flip), the written cost within rtol 1e-6 where the
    depths agree."""
    depth, cands, masks, (track, tinb, rig, Rs, ts), p = _cost_inputs()
    n = rig.shape[0]
    bands = tcost.split_bands([CPU] * n_bands, track, tinb, rig, Rs, ts)
    assert [b.y0 for b in bands] == [a for a, _ in hints.bounds(depth.shape[0], n_bands)]
    whole = tcost.cost_map_score(cands, track, tinb, rig, Rs, ts, n, p)
    banded = tcost.cost_map_score_bands(cands, bands, n, p)
    np.testing.assert_allclose(banded.numpy(), whole.numpy(), rtol=1e-6, atol=0)
    cost0 = whole[0].clone()
    d_w, c_w = tcost.cost_map_accept(depth.clone(), cost0.clone(), cands, masks, track, tinb,
                                     rig, Rs, ts, n, p)
    d_b, c_b = tcost.cost_map_accept_bands(depth.clone(), cost0.clone(), cands, masks, bands, n, p)
    same = (d_b == d_w).numpy()
    assert same.mean() >= 0.999
    np.testing.assert_allclose(c_b.numpy()[same], c_w.numpy()[same], rtol=1e-6, atol=0)
    assert (d_w != depth).any()  # the batch changed something


@pytest.mark.parametrize("n_bands", [2, 3, 4])
@pytest.mark.parametrize("shape", [(3, 29, 40), (1, 9, 5)])
def test_band_fb_smooth_equals_whole_map(n_bands, shape):
    """The row pass on bands of rows, gathered, then the column pass on
    bands of columns: exactly the whole-map plain version."""
    prob = torch.as_tensor(np.random.default_rng(3).uniform(0, 1, shape).astype(np.float32))
    whole = tfb.fb_smooth(prob, 0.5, 0.9)
    out = torch.full_like(prob, -1.0)
    banded = tfb.fb_smooth_bands(prob, 0.5, 0.9, [CPU] * n_bands, out=out)
    assert banded is out
    np.testing.assert_array_equal(banded.numpy(), whole.numpy())
    rows = tfb.fb_smooth_pass(prob, 0.5, 0.9, columns=False)
    both = tfb.fb_smooth_pass(rows, 0.5, 0.9, columns=True)
    np.testing.assert_array_equal(both.numpy(), whole.numpy())


# --------------------------------------------------------------------------
# the sharded EM step and solve against a mesh of one
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["sp8", "sp4xhyp2"])
def test_multichip_em_step_matches_mesh_of_one(mesh):
    """test_multichip.py:37-68: the pose step of frame 0 and a depth round.
    Limits: > 99.5% of entries within atol 2e-5, max relative error < 0.05
    (measured: both meshes equal to the mesh of one)."""
    n, h, w = 3, 32, 128
    flows, depth = _tiny_window(n, h, w)
    cfg = _cfg(h, w)
    outs = []
    for m in (make_mesh(1, devices=[CPU]), MESHES[mesh]()):
        f, rig, d = shard_window(m, flows, np.ones((n, h, w), np.float32), depth)
        outs.append(multichip_em_step(m, cfg, f, rig, d, _poses0(n)))
    for a, b in zip(*outs):
        a, b = a.numpy(), b.numpy()
        assert a.shape == b.shape
        assert np.isclose(a, b, atol=2e-5).mean() > 0.995
        assert _rel(a, b).max() < 0.05


@pytest.mark.parametrize("mesh", ["sp4", "sp4xhyp2", "sp2xhyp2"])
def test_multichip_solve_matches_mesh_of_one(mesh):
    """test_multichip.py:71-126: the full solve (2 EM iterations) on the
    consistent window. Limits: max relative error poses6 / covars < 2e-3,
    depth / rigidness < 0.05. Measured: all three equal to the mesh of
    one."""
    n, h, w = 3, 32, 128
    flows, depth0 = _consistent_window(n, h, w)
    cfg = _cfg(h, w, max_iters=2)
    outs = [multichip_solve(m, cfg, flows, depth0, _poses0(n))
            for m in (make_mesh(1, devices=[CPU]), MESHES[mesh]())]
    assert outs[1]["n_flows"] == n
    tol = {"poses6": 2e-3, "covars": 2e-3, "depth": 0.05, "rigidness": 0.05}
    for k, bound in tol.items():
        assert outs[0][k].shape == outs[1][k].shape
        assert _rel(outs[0][k], outs[1][k]).max() < bound, k


def test_multichip_solve_pads_and_crops_rows():
    """30 rows are padded to 32 with inert rows and cropped back; every
    output is finite, and the sp = 4 bands (8 rows each) agree with the
    mesh of one within test_multichip_solve_matches_mesh_of_one's limits
    (measured: equal)."""
    n, h, w = 3, 30, 96
    flows, depth0 = _consistent_window(n, h, w)
    cfg = _cfg(h, w, max_iters=2)
    a = multichip_solve(make_mesh(1, devices=[CPU]), cfg, flows, depth0, _poses0(n))
    b = multichip_solve(MESHES["sp4"](), cfg, flows, depth0, _poses0(n))
    assert a["depth"].shape == (h, w) and a["rigidness"].shape == (n, h, w)
    assert a["poses6"].shape == (n, 6) and a["rig_dens"].shape == (n,)
    for k in ("poses6", "covars", "depth", "rigidness", "densities"):
        assert torch.isfinite(a[k]).all(), k
    tol = {"poses6": 2e-3, "covars": 2e-3, "depth": 0.05, "rigidness": 0.05}
    for k, bound in tol.items():
        assert b[k].shape == a[k].shape
        assert _rel(a[k], b[k]).max() < bound, k


def test_multichip_solve_crops_only_rows():
    """A window whose width equals its padded row count (30 x 32, rows
    padded to 32): only the row axis of each state entry is cropped (the
    JAX package's crop, every axis of the padded size, ``mesh.py:142-151``,
    would take the columns too). sp = 4 agrees with the mesh of one within
    test_multichip_solve_matches_mesh_of_one's limits (measured: equal)."""
    n, h, w = 3, 30, 32
    flows, depth0 = _consistent_window(n, h, w, focal=20.0)
    cfg = _cfg(h, w, focal=20.0, max_iters=2)
    a = multichip_solve(make_mesh(1, devices=[CPU]), cfg, flows, depth0, _poses0(n))
    b = multichip_solve(MESHES["sp4"](), cfg, flows, depth0, _poses0(n))
    for st in (a, b):
        assert st["depth"].shape == (h, w) and st["rigidness"].shape == (n, h, w)
        assert st["poses6"].shape == (n, 6) and st["covars"].shape == (n, 6, 6)
        assert st["dp_confs"].shape == (0, h, w) and st["tinb"].shape == (n, h, w)
        assert all(t.shape == (n, h, w) for t in st["track"])
        for k in ("poses6", "depth", "rigidness"):
            assert torch.isfinite(st[k]).all(), k
    tol = {"poses6": 2e-3, "covars": 2e-3, "depth": 0.05, "rigidness": 0.05}
    for k, bound in tol.items():
        assert _rel(a[k], b[k]).max() < bound, k


@pytest.mark.slow
def test_multichip_solve_kitti_shape():
    """test_multichip.py:129-185 at the KITTI compute grid (185 x 616, a
    window of 5, three planes) on the 4 x 2 mesh: finite outputs, poses
    within atol 5e-3 of the mesh of one, the 99th percentile of the depth's
    relative difference < 0.05."""
    n, h, w = 5, 185, 616
    planes = [(_n([0.1, 0.15, 1.0]), 8.0), (_n([-0.35, 0.1, 1.0]), 6.5),
              (_n([0.3, -0.4, 1.0]), 7.0)]
    flows, depth0 = _consistent_window(n, h, w, focal=300.0, planes=planes)
    cfg = VoldorConfig(fx=300.0, fy=300.0, cx=w / 2, cy=h / 2, basefocal=150.0)
    cfg.n_poses_to_sample = 512
    cfg.depth_rand_samples = 2
    cfg.max_iters = 2
    outs = [multichip_solve(m, cfg, flows, depth0, _poses0(n))
            for m in (make_mesh(1, devices=[CPU]), MESHES["sp4xhyp2"]())]
    for out in outs:
        for k in ("poses6", "depth", "rigidness"):
            assert torch.isfinite(out[k]).all(), k
    np.testing.assert_allclose(outs[0]["poses6"].numpy(), outs[1]["poses6"].numpy(),
                               rtol=0, atol=5e-3)
    assert np.quantile(_rel(outs[0]["depth"], outs[1]["depth"]), 0.99) < 0.05
