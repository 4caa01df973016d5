"""Pose-graph optimisation of the port (voldor_tpu_torch/pgo) against the
JAX package, on the CPU, over the drifted circle graphs of tests/test_pgo.py.

Tolerances, and why:
* build_problem (remap, whitening, dropped edges): atol 1e-6; the edge
  residuals and forward-mode Jacobians: 1e-5 of their largest entry.
* The first LM iterations (2 dense, 3 CG), while the cost is far above
  float noise: poses within 1e-5, the cost within 1e-2 relative (it fell
  by 1e3-1e5 from its start, which amplifies its last bits).
* Whole solves: PGO's stop rule, a relative cost drop below 1e-9, cannot
  fire in float32 (an accepted step lowers the cost by at least one ulp,
  ~6e-8 relative), so a solve ends when the damping blows up after a run
  of float-noise accepts and rejects. The iteration count of a whole solve
  is therefore not reproducible: the JAX package's own count moves by up
  to +-10 when an initial pose moves by 1e-6. Held: poses within 2e-4
  (6-dof, position) and rotations within 1e-4; the final cost within 1e-3
  relative (or 1e-6 absolute on a consistent graph); the chosen path.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voldor_tpu.ops import lie as jlie
from voldor_tpu.pgo import api as japi
from voldor_tpu.pgo import g2o as jg2o
from voldor_tpu.pgo import solver as jsol
from voldor_tpu_torch.pgo import api as tapi
from voldor_tpu_torch.pgo import g2o as tg2o
from voldor_tpu_torch.pgo import solver as tsol

from test_pgo import _circle_graph, _rel_pose7

CPU = torch.device("cpu")


def _graph(n=30, seed=0, loops=((0, -1),), scale_noise=0.0):
    """A circle with exact relative measurements, drifted initial poses."""
    rng = np.random.default_rng(seed)
    gt = _circle_graph(n)
    noisy = gt.copy()
    noisy[1:, 3:6] += rng.normal(0, 0.05, (n - 1, 3)).cumsum(0)
    noisy[1:, :3] += rng.normal(0, 0.01, (n - 1, 3)).cumsum(0)
    noisy[1:, 6] += rng.normal(0, scale_noise, n - 1).cumsum(0)
    edges = [[i, i + 1] for i in range(n - 1)] + [[a % n, b % n] for a, b in loops]
    edges_idx = np.asarray(edges, np.int32)
    edges_pose = np.stack([_rel_pose7(gt, i, j) for i, j in edges_idx])
    covar = np.tile((np.eye(7) * 1e-4).astype(np.float32), (len(edges_idx), 1, 1))
    return gt, noisy, edges_idx, edges_pose, covar


def _rot(poses):
    return np.asarray(jlie.so3_exp(jnp.asarray(np.asarray(poses)[:, :3])))


def _same_poses(a, b, t_atol=2e-4, r_atol=1e-4):
    np.testing.assert_allclose(a[:, 3:6], b[:, 3:6], rtol=0, atol=t_atol)
    np.testing.assert_allclose(_rot(a), _rot(b), rtol=0, atol=r_atol)
    np.testing.assert_allclose(a[:, 6], b[:, 6], rtol=0, atol=t_atol)


def _spy(monkeypatch, module, name):
    """Record what module.name returns (the port's pgo() reports no path
    or cost of its own)."""
    seen = []
    real = getattr(module, name)

    def spy(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    monkeypatch.setattr(module, name, spy)
    return seen


def _problems(noisy, edges_idx, edges_pose, covar, dof7, poses_idx=None):
    pj, ids_j, info_j = jsol.build_problem(noisy, poses_idx, edges_idx, edges_pose, covar, dof7)
    pt, ids_t, info_t = tsol.build_problem(noisy, poses_idx, edges_idx, edges_pose, covar, dof7,
                                           CPU)
    assert info_j == info_t
    np.testing.assert_array_equal(ids_j, ids_t)
    return pj, pt, info_t


@pytest.mark.parametrize("dof7", [False, True])
def test_build_problem_and_jacobians_match_jax(dof7):
    _, noisy, edges_idx, edges_pose, covar = _graph(12, scale_noise=0.02)
    covar[4] = np.nan  # dropped on both sides
    ids = np.arange(100, 112)
    pj, pt, info = _problems(noisy, edges_idx + 100, edges_pose, covar, dof7, poses_idx=ids)
    n, m = info["n_poses"], info["n_edges"]
    assert m == len(edges_idx) - 1
    for f in ("p", "q", "s", "free_mask"):
        np.testing.assert_allclose(getattr(pt, f).numpy(), np.asarray(getattr(pj, f))[:n],
                                   rtol=0, atol=1e-6, err_msg=f)
    for f in ("edges_idx", "meas_p", "meas_q", "meas_s", "sqrt_info"):
        np.testing.assert_allclose(getattr(pt, f).numpy(), np.asarray(getattr(pj, f))[:m],
                                   rtol=0, atol=1e-6 * max(1.0, np.abs(np.asarray(getattr(pj, f))).max()),
                                   err_msg=f)
    r_j, Je_j, Jb_j = (np.asarray(a)[:m] for a in jsol._edge_res_and_jacs(pj))
    r_t, Je_t, Jb_t = (a.numpy() for a in tsol._edge_res_and_jacs(pt))
    for a, b in ((r_t, r_j), (Je_t, Je_j), (Jb_t, Jb_j)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("dof7", [False, True])
def test_first_lm_iterations_match_jax(solver, dof7):
    """The first iterations, while the cost is still far above float noise
    (1e-4 of its start after 2 dense or 3 CG iterations)."""
    _, noisy, edges_idx, edges_pose, covar = _graph(20, seed=1, scale_noise=0.02 * dof7)
    pj, pt, info = _problems(noisy, edges_idx, edges_pose, covar, dof7)
    jf = jsol.pgo_solve_dense_jit if solver == "dense" else jsol.pgo_solve_jit
    tf = tsol.pgo_solve_dense_jit if solver == "dense" else tsol.pgo_solve_jit
    k = 2 if solver == "dense" else 3
    sj, cj, ij = jf(pj, max_iters=k)
    st, ct, it = tf(pt, max_iters=k)
    assert int(ij) == int(it) == k
    n = info["n_poses"]
    for f in ("p", "q", "s"):
        np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(sj, f))[:n],
                                   rtol=0, atol=1e-5, err_msg=f)
    # the cost fell by 1e3-1e5 from its start: its last bits are amplified
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-2)


@pytest.mark.parametrize("dof7", [False, True])
@pytest.mark.parametrize("n", [30, 60])
def test_pgo_matches_jax(n, dof7, monkeypatch):
    gt, noisy, edges_idx, edges_pose, covar = _graph(n, seed=n, loops=((0, -1), (0, n // 2)),
                                                     scale_noise=0.02 * dof7)
    dense_j = _spy(monkeypatch, japi, "pgo_solve_dense_jit")
    dense_t = _spy(monkeypatch, tapi, "pgo_solve_dense_jit")
    out_j = japi.pgo(noisy, edges_idx, edges_pose, covar, optimize_7dof=dof7)
    out_t = tapi.pgo(noisy, edges_idx, edges_pose, covar, optimize_7dof=dof7, device="cpu")
    assert len(dense_t) == len(dense_j) == 1  # both took the dense path
    _same_poses(out_t, out_j)
    np.testing.assert_allclose(out_t[0], noisy[0], rtol=0, atol=1e-6)  # the gauge pose
    np.testing.assert_allclose(float(dense_t[0][1]), float(dense_j[0][1]), rtol=1e-3, atol=1e-6)
    if dof7:  # the loop closes the scale drift
        np.testing.assert_allclose(out_t[:, 6], 0.0, atol=5e-3)


def test_cg_matches_jax_and_dense():
    _, noisy, edges_idx, edges_pose, covar = _graph(30, seed=4)
    pj, pt, info = _problems(noisy, edges_idx, edges_pose, covar, False)
    sj, cj, _ = jsol.pgo_solve_jit(pj)
    st, ct, _ = tsol.pgo_solve_jit(pt)
    sd, cd, _ = tsol.pgo_solve_dense_jit(pt)
    n = info["n_poses"]
    np.testing.assert_allclose(st.p.numpy(), np.asarray(sj.p)[:n], rtol=0, atol=2e-4)
    np.testing.assert_allclose(np.abs(np.sum(st.q.numpy() * np.asarray(sj.q)[:n], -1)), 1.0,
                               atol=1e-5)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-3, atol=1e-6)
    # and the port's two solvers land on the same optimum (test_pgo.py's
    # test_pgo_dense_matches_cg)
    assert float(cd) <= float(ct) * 1.05 + 1e-6
    np.testing.assert_allclose(sd.p.numpy(), st.p.numpy(), atol=2e-3)


@pytest.mark.parametrize("dof7", [False, True])
def test_chain_reduction_matches_jax(dof7, monkeypatch):
    _, noisy, edges_idx, edges_pose, covar = _graph(40, seed=5, loops=((0, -1), (10, 30)),
                                                    scale_noise=0.02 * dof7)
    reduced = _spy(monkeypatch, tapi, "chain_reduce")
    dense = _spy(monkeypatch, tapi, "pgo_solve_dense_jit")
    out_j = japi.pgo(noisy, edges_idx, edges_pose, covar, optimize_7dof=dof7,
                     reduce_threshold_dofs=0)
    out_t = tapi.pgo(noisy, edges_idx, edges_pose, covar, optimize_7dof=dof7,
                     reduce_threshold_dofs=0, device="cpu")
    assert len(reduced) == len(dense) == 1 and len(reduced[0][0]) < 40  # the kept poses
    _same_poses(out_t, out_j)


def test_nonfinite_covar_edges_dropped(capsys):
    gt, _, edges_idx, edges_pose, covar = _graph(8)
    covar[3] = np.nan
    out_j = japi.pgo(gt, edges_idx, edges_pose, covar, debug=True)
    cap_j = capsys.readouterr().out
    out_t = tapi.pgo(gt, edges_idx, edges_pose, covar, debug=True, device="cpu")
    cap_t = capsys.readouterr().out
    assert "Nan/Inf" in cap_j and "Nan/Inf" in cap_t
    assert "Number of constraints: 7" in cap_t and "Number of constraints: 7" in cap_j
    assert np.isfinite(out_t).all()
    _same_poses(out_t, out_j)


def test_poses_idx_remap_matches_jax():
    gt = _circle_graph(6)
    ids = np.asarray([10, 11, 12, 13, 14, 15], np.int32)
    edges_idx = np.asarray([[10 + i, 11 + i] for i in range(5)], np.int32)
    edges_pose = np.stack([_rel_pose7(gt, i, i + 1) for i in range(5)])
    covar = np.tile((np.eye(7) * 1e-4).astype(np.float32), (5, 1, 1))
    start = gt.copy()
    start[1:, 3] += 0.05
    out_j = japi.pgo(start, edges_idx, edges_pose, covar, poses_idx=ids)
    out_t = tapi.pgo(start, edges_idx, edges_pose, covar, poses_idx=ids, device="cpu")
    _same_poses(out_t, out_j)
    np.testing.assert_allclose(out_t[:, 3:6], gt[:, 3:6], atol=1e-3)
    # no edges: the poses come back unchanged
    np.testing.assert_array_equal(tapi.pgo(start, edges_idx[:0], edges_pose[:0], covar[:0],
                                           device="cpu"), start)


def test_g2o_round_trip_matches_jax(tmp_path):
    gt, noisy, edges_idx, edges_pose, covar = _graph(10, seed=7)
    for mod, name in ((jg2o, "j.g2o"), (tg2o, "t.g2o")):
        mod.write_g2o(str(tmp_path / name), np.arange(10), noisy)
    assert (tmp_path / "j.g2o").read_text() == (tmp_path / "t.g2o").read_text()
    # a file with edges: vertices from write_g2o plus EDGE_SE3:QUAT lines
    lines = (tmp_path / "t.g2o").read_text()
    info6 = " ".join(str(v) for v in [100.0, 0, 0, 0, 0, 0, 100.0, 0, 0, 0, 0, 100.0, 0, 0, 0,
                                      400.0, 0, 0, 400.0, 0, 400.0])
    for i in range(9):
        lines += f"EDGE_SE3:QUAT {i} {i + 1} 1.0 0.1 0.0 0.0 0.0 0.0998 0.995 {info6}\n"
    (tmp_path / "e.g2o").write_text(lines)
    rj, rt = jg2o.read_g2o(str(tmp_path / "e.g2o")), tg2o.read_g2o(str(tmp_path / "e.g2o"))
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a, b)
    ids, poses, e_idx, e_pose, e_cov = rt
    np.testing.assert_allclose(poses[:, 3:6], noisy[:, 3:6], rtol=0, atol=1e-5)
    out_j = japi.pgo(poses, e_idx, e_pose, e_cov, poses_idx=ids)
    out_t = tapi.pgo(poses, e_idx, e_pose, e_cov, poses_idx=ids, device="cpu")
    _same_poses(out_t, out_j)


def test_device_none_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gt, _, edges_idx, edges_pose, covar = _graph(6)
    import voldor_tpu_torch

    for fn in (tapi.pgo, voldor_tpu_torch.pgo):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(gt, edges_idx, edges_pose, covar)
