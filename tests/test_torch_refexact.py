"""The JAX package's reference-exact VO configuration in the PyTorch port,
against the JAX package on the CPU: the projected cost
(``em.compute_cost_map``), the exact local propagation, AP3P, the traced
all-frames collect of the batched sweep, and one whole oracle window
(``tests/test_parity.py``'s ``REFERENCE_EXACT`` at its 72x96 scene and
budget).

Inputs are seeded numpy arrays fed to both packages. The JAX side runs op
by op (``jax.disable_jit``), as in tests/test_torch_em.py, so both round
every step the same way. Random draws are taken from the JAX side's own
``jax.random`` calls and fed to the port. Tolerances are stated per test.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import voldor_tpu
import voldor_tpu_torch
from voldor_tpu.config import VoldorConfig
from voldor_tpu.ops import ap3p as jap3p
from voldor_tpu.ops import lie as jlie
from voldor_tpu.vo import em as jem
from voldor_tpu.vo import pose_step as jps
from voldor_tpu_torch.convert import em_params_from_numpy
from voldor_tpu_torch.ops import ap3p as tap3p
from voldor_tpu_torch.ops import p3p as tp3p
from voldor_tpu_torch.vo import em as tem
from voldor_tpu_torch.vo import pose_step as tps

from synthetic import plane_depth, render_window

H, W = 72, 96
K = np.array([[80.0, 0, 48.0], [0, 80.0, 36.0], [0, 0, 1]], np.float32)
TOL = dict(rtol=1e-5, atol=1e-5)
COLLECT = dict(rigidness_threshold=0.5, rigidness_sum_threshold=1.0, sample_min_depth=0.1,
               sample_max_depth=1000.0, max_trace_on_flow=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel
    processes, and every process's default thread pool at once
    oversubscribes the cores many times over (as tests/test_torch_lc.py's
    one_torch_thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _norm(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


PLANES = [
    (_norm([0.1, 0.15, 1.0]), 8.0),
    (_norm([-0.35, 0.1, 1.0]), 6.5),
    (_norm([0.3, -0.25, 1.0]), 7.0),
]


def _r2R(rv):
    return np.asarray(jlie.so3_exp(jnp.asarray(np.asarray(rv, np.float32))))


def _t(a):
    return torch.as_tensor(np.array(a))


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _agree(a, b, frac=0.999):
    """Elementwise within TOL (same +inf pattern) on at least ``frac`` of
    the pixels: a per-pixel accept between candidates whose costs tie to
    float rounding may pick the other one."""
    a, b = np.asarray(a), np.asarray(b)
    same = np.isclose(a, b, **TOL) | (np.isinf(a) & np.isinf(b))
    assert same.mean() >= frac, same.mean()


@pytest.fixture(scope="module")
def win():
    """tests/test_torch_em.py's window: 3 flows, two depth priors (a 3%-off
    frame-0 depth and frame 1's depth), seeded prior confidences, and a
    rigidness of a 2%-off depth with a zero block, so the flow arm's
    weights vanish there."""
    n = 3
    poses = np.zeros((n, 6), np.float32)
    rng = np.random.default_rng(7)
    for f in range(n):
        poses[f, :3] = rng.normal(0, 0.01, 3)
        poses[f, 3:6] = [0.5 + 0.05 * rng.normal(), 0.05 * rng.normal(), 0.2]
    flows, depth0, Ts = render_window(K, poses, PLANES, H, W, _r2R)
    cfg = VoldorConfig(fx=80.0, fy=80.0, cx=48.0, cy=36.0, basefocal=40.0)
    Rs = np.stack([_r2R(q[:3]) for q in poses])
    depth1 = plane_depth(K, Ts[1][:3, :3], Ts[1][:3, 3], PLANES, H, W)
    dp_poses = np.stack([np.zeros(6, np.float32), poses[0]])
    p = jem.EmParams.from_config(cfg, has_disparity=False)
    rig = np.array(jem.update_rigidness(
        jnp.asarray(depth0 * 1.02), jnp.asarray(flows), jnp.asarray(Rs),
        jnp.asarray(poses[:, 3:6]), jnp.int32(n), p))
    rig[:, 30:40, 40:60] = 0.0
    confs = rng.uniform(0.2, 1.0, (2, H, W)).astype(np.float32)
    confs[:, 30:40, 40:60] = 0.0
    return dict(
        cfg=cfg, flows=flows, depth0=depth0, poses=poses, Rs=Rs, ts=poses[:, 3:6], rig=rig,
        priors=np.stack([depth0 * 1.03, depth1]).astype(np.float32),
        dp_Rs=np.stack([_r2R(q[:3]) for q in dp_poses]), dp_ts=dp_poses[:, 3:6],
        pconfs=rng.uniform(0.5, 1.0, (2, H, W)).astype(np.float32), confs=confs,
    )


def _params(win, disparity):
    p = jem.EmParams.from_config(win["cfg"], has_disparity=disparity)
    return p, em_params_from_numpy(p)


def _cost_args(win):
    return (win["flows"], win["rig"], win["Rs"], win["ts"], win["priors"], win["pconfs"],
            win["confs"], win["dp_Rs"], win["dp_ts"])


# --------------------------------------------------------------------------
# the projected cost and the exact chains
# --------------------------------------------------------------------------


@pytest.mark.parametrize("disparity,active_n", [(False, 3), (True, 3), (True, 2)])
def test_compute_cost_map_matches_jax(win, disparity, active_n):
    """Flows plus both priors, with and without the disp_delta slot 0, and a
    shorter active window. rtol = atol = 1e-5; the +inf pixels (zero
    weights) identical."""
    p, tp = _params(win, disparity)
    cand = (win["depth0"] * (1.0 + 0.05 * np.sin(np.arange(W) / 7.0))[None, :]).astype(np.float32)
    args = _cost_args(win)
    with jax.disable_jit():
        c_j = np.asarray(jem.compute_cost_map(jnp.asarray(cand), *_j(*args), jnp.int32(active_n), p))
    c_t = tem.compute_cost_map(_t(cand), *(_t(a) for a in args), active_n, tp).numpy()
    # +inf where the flow weights vanish (the zero block) and the sampled
    # prior confidences too
    assert 0 < np.isinf(c_j).sum() <= 200
    np.testing.assert_array_equal(np.isinf(c_t), np.isinf(c_j))
    fin = np.isfinite(c_j)
    np.testing.assert_allclose(c_t[fin], c_j[fin], **TOL)


@pytest.mark.parametrize("mode", ["jump", "exact"])
def test_optimize_depth_projected_matches_jax(win, mode):
    """One depth round with the projected cost (flows and priors, disparity
    slot on), 'jump' and 'exact' local propagation, with the per-proposal
    uniforms of em.py:493-497 rebuilt from the JAX key. Depth and cost
    within 1e-5 on >= 99.9% of pixels."""
    p, tp = _params(win, True)
    key = jax.random.PRNGKey(5)
    n_rand, gstep, lwidth = 3, 8, 4
    u = np.stack([np.asarray(jax.random.uniform(k, (H, W), jnp.float32))
                  for k in jax.random.split(key, n_rand)])
    depth = (win["depth0"] * 1.04).astype(np.float32)
    args = _cost_args(win)
    kw = dict(global_prop_step=gstep, local_prop_width=lwidth, range_factor=1.0,
              local_prop_mode=mode)
    with jax.disable_jit():
        ja = _j(*args)
        c0 = jem.compute_cost_map(jnp.asarray(depth), *ja, jnp.int32(3), p)
        d_j, c_j = jem.optimize_depth(jnp.asarray(depth), c0, *ja, jnp.int32(3), p, key,
                                      n_rand_samples=n_rand, **kw)
    ta = [_t(a) for a in args]

    def cost_fn(d):
        return tem.compute_cost_map(d, *ta, 3, tp)

    d0 = _t(depth)
    d_t, c_t = tem.optimize_depth(d0, cost_fn(d0), cost_fn, _t(u), **kw)
    _agree(d_t.numpy(), d_j)
    _agree(c_t.numpy(), c_j)
    assert (np.asarray(d_j) != depth).mean() > 0.05  # the round moved the depth


# --------------------------------------------------------------------------
# AP3P
# --------------------------------------------------------------------------


def test_ap3p_quartic_known_roots():
    """(x-1)(x+2)(x-3)(x+0.5): the port's roots within 1e-3 of the truth and
    1e-5 of the JAX package's."""
    roots_true = np.array([1.0, -2.0, 3.0, -0.5])
    c = np.poly(roots_true).astype(np.float32)
    with jax.disable_jit():
        r_j = np.sort(np.asarray(jap3p._solve_quartic(*[jnp.float32(x) for x in c])))
    r_t = np.sort(tap3p._solve_quartic(*[torch.tensor(x) for x in c]).numpy())
    np.testing.assert_allclose(r_t, np.sort(roots_true), atol=1e-3)
    np.testing.assert_allclose(r_t, r_j, **TOL)


def _p4p_instance(rng, fx, fy, cx, cy):
    """Four points 4-12 m in front of a camera with a random pose, and
    their exact pixels."""
    rvec = rng.normal(0, 0.2, 3).astype(np.float32)
    tvec = rng.normal(0, 0.5, 3).astype(np.float32)
    R = _r2R(rvec)
    pc = np.stack([rng.uniform(-2, 2, 4), rng.uniform(-2, 2, 4), rng.uniform(4, 12, 4)], -1)
    pts3 = ((pc - tvec) @ R).astype(np.float32)  # world = R^T (cam - t)
    pts2 = np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], -1)
    return pts2.astype(np.float32), pts3, rvec, tvec


def test_ap3p_single_matches_jax():
    """20 exact instances through the port's batch of one and the JAX
    package's single solver: the port recovers at least 16 (as the JAX
    package's own test asks of it) to atol 2e-2 / 5e-2, with the same
    success flags, and agrees with the JAX pose to 1e-3 where both
    recover."""
    rng = np.random.default_rng(3)
    fx, fy, cx, cy = 400.0, 420.0, 320.0, 240.0
    n_exact = 0
    for _ in range(20):
        pts2, pts3, rvec, tvec = _p4p_instance(rng, fx, fy, cx, cy)
        with jax.disable_jit():
            r_j, t_j, ok_j = jap3p._ap3p_p4p_single(jnp.asarray(pts2), jnp.asarray(pts3), fx, fy, cx, cy)
        r_t, t_t, ok_t = tap3p._ap3p_p4p_batch(_t(pts2)[None], _t(pts3)[None], fx, fy, cx, cy)
        r_t, t_t, ok_t = r_t[0].numpy(), t_t[0].numpy(), bool(ok_t[0])
        assert ok_t == bool(ok_j)
        if not ok_t:
            continue
        R = _r2R(r_t)
        pc = pts3 @ R.T + t_t
        reproj = np.abs(np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], -1)
                        - pts2).max()
        if reproj < 1.0:
            n_exact += 1
            np.testing.assert_allclose(r_t, rvec, atol=2e-2)
            np.testing.assert_allclose(t_t, tvec, atol=5e-2)
            np.testing.assert_allclose(r_t, np.asarray(r_j), atol=1e-3)
            np.testing.assert_allclose(t_t, np.asarray(t_j), atol=1e-3)
    assert n_exact >= 16


@pytest.fixture(scope="module")
def exact_pool():
    """tests/test_pose_ops.py's batch: 500 exact correspondences and a NaN
    tail that must never be drawn, 256 subsets drawn by the JAX key."""
    rng = np.random.default_rng(233)
    fx, fy, cx, cy = 400.0, 420.0, 320.0, 240.0
    rvec = np.array([0.05, -0.1, 0.02], np.float32)
    tvec = np.array([0.3, -0.1, 0.5], np.float32)
    R = _r2R(rvec)
    M = 600
    pts3 = rng.uniform(-3, 3, size=(M, 3)).astype(np.float32)
    pts3[:, 2] = rng.uniform(5, 20, size=M)
    pc = pts3 @ R.T + tvec
    pts2 = np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy],
                    axis=-1).astype(np.float32)
    valid = np.ones(M, bool)
    valid[500:] = False
    pts2[500:] = np.nan
    pts3[500:] = np.nan
    key = jax.random.PRNGKey(0)
    idx = np.asarray(jax.random.randint(key, (256, 4), 0, 500))
    return dict(pts2=pts2, pts3=pts3, valid=valid, key=key, idx=idx, rvec=rvec, tvec=tvec,
                intr=(fx, fy, cx, cy))


def test_solve_batch_p4p_ap3p_matches_jax(exact_pool):
    """The same 256 subsets through both packages' AP3P batch (the JAX side
    compiled: op by op it takes 12 s). Success flags differ on at most 1%
    of the subsets (the float32 quartic polish is branch-sensitive; the
    share is printed); where both solved, rvec and t agree to 1e-3 on >= 97%
    of them (on the others the two pick different roots of a near-tie:
    2.6e-3 to 0.6 apart here); the port's poses recover the truth (median
    error 5e-3 / 2e-2, the JAX package's own bounds)."""
    ep = exact_pool
    fx, fy, cx, cy = ep["intr"]
    rv, tv, ok = (np.asarray(a) for a in jap3p.solve_batch_p4p_ap3p(
        jnp.asarray(ep["pts2"]), jnp.asarray(ep["pts3"]), jnp.asarray(ep["valid"]),
        ep["key"], fx, fy, cx, cy, n_poses=256))
    trv, ttv, tok = (a.numpy() for a in tap3p.solve_batch_p4p_ap3p(
        _t(ep["pts2"]), _t(ep["pts3"]), _t(ep["valid"]), _t(ep["idx"]), fx, fy, cx, cy))
    disagree = (ok != tok).mean()
    print(f"AP3P success flags differ on {disagree:.4f} of the subsets")
    assert tok.mean() > 0.9 and disagree <= 0.01
    both = ok & tok
    err = np.maximum(np.abs(trv - rv).max(axis=1), np.abs(ttv - tv).max(axis=1))[both]
    assert (err <= 1e-3).mean() >= 0.97, np.sort(err)[-10:]
    assert np.median(np.linalg.norm(trv[tok] - ep["rvec"], axis=1)) < 5e-3
    assert np.median(np.linalg.norm(ttv[tok] - ep["tvec"], axis=1)) < 2e-2


def test_minimal_solver_registry_and_shared_draws(exact_pool):
    """--lambdatwist 1/0 pick LambdaTwist / AP3P, and both solve the same
    4-subsets to the same pose on exact data (median 5e-3 / 2e-2)."""
    assert tps._get_batch_p4p("lambdatwist") is tp3p.solve_batch_p4p
    assert tps._get_batch_p4p("ap3p") is tap3p.solve_batch_p4p_ap3p
    with pytest.raises(ValueError):
        tps._get_batch_p4p("nope")
    ep = exact_pool
    args = (_t(ep["pts2"]), _t(ep["pts3"]), _t(ep["valid"]), _t(ep["idx"]), *ep["intr"])
    lr, lt, lok = tp3p.solve_batch_p4p(*args)
    ar, at, aok = tap3p.solve_batch_p4p_ap3p(*args)
    both = (lok & aok).numpy()
    assert both.mean() > 0.9
    assert np.median(np.linalg.norm((lr - ar).numpy()[both], axis=1)) < 5e-3
    assert np.median(np.linalg.norm((lt - at).numpy()[both], axis=1)) < 2e-2


@pytest.mark.parametrize("solver", ["lambdatwist", "ap3p"])
def test_optimize_camera_pose_recovers_frame(win, solver):
    """The single-frame wrapper over _pose_step_core with either minimal
    solver, on the exact window with frame 1's pose unknown (zero) and
    frame 0's known: frame 1 recovered to rotation atol 2e-3, translation
    atol 1e-2 (the draws differ from the JAX package's, so it is held to
    the truth), the other rows untouched."""
    p, tp = _params(win, False)
    poses = win["poses"].copy()
    poses[1] = 0.0
    hp = dict(COLLECT, pose_sample_stride=1, n_poses_to_sample=1024, meanshift_kernel_var=0.1,
              meanshift_rvec_scale=25.0, meanshift_epsilon=1e-5, meanshift_max_iters=100,
              meanshift_max_init_trials=20, meanshift_good_init_confidence=0.5,
              rg_trunc_sigma=3.0, rg_covar_reg_lambda=0.001, rg_pose_scaling=100.0,
              rg_epsilon=1e-5, rg_max_iters=100, minimal_solver=solver)
    res = tps.optimize_camera_pose(
        _t(win["depth0"]), _t(win["flows"]), torch.ones((3, H, W)), _t(poses),
        torch.zeros((3, 6, 6)), 1, False, True, 11, tp, **hp)
    assert bool(res.success) and int(res.pose_sample_count) > 500
    out = res.poses6.numpy()
    np.testing.assert_allclose(out[1, :3], win["poses"][1, :3], atol=2e-3)
    np.testing.assert_allclose(out[1, 3:], win["poses"][1, 3:], atol=1e-2)
    np.testing.assert_array_equal(out[[0, 2]], poses[[0, 2]])


# --------------------------------------------------------------------------
# the traced collect of every frame
# --------------------------------------------------------------------------


@pytest.mark.parametrize("stride,active_n", [(1, 3), (2, 3), (1, 2)])
def test_collect_all_matches_jax_and_per_frame(win, stride, active_n):
    """collect_p3p_instances_all against the JAX package's (identical
    validity, p2 atol 1e-3 px, p3 atol 1e-4) and against the port's own
    per-frame traced collect (as tests/test_window_sweep.py:50 holds the
    JAX package's); frames >= active_n all invalid."""
    p, tp = _params(win, False)
    rng = np.random.default_rng(stride * 10 + active_n)
    rig = rng.uniform(0.3, 1.0, (3, H, W)).astype(np.float32)
    kw = dict(COLLECT, sample_stride=stride)
    args = (win["depth0"], win["flows"], rig, win["Rs"], win["ts"])
    with jax.disable_jit():
        p2, p3, v = (np.asarray(a) for a in jps.collect_p3p_instances_all(
            *_j(*args), jnp.int32(active_n), p, **kw))
    tp2, tp3, tv = (a.numpy() for a in tps.collect_p3p_instances_all(
        *(_t(a) for a in args), active_n, tp, **kw))
    np.testing.assert_array_equal(tv, v)
    assert v[:active_n].mean() > 0.3 and not v[active_n:].any()
    np.testing.assert_allclose(tp2[v], p2[v], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tp3[v], p3[v], rtol=1e-5, atol=1e-4)
    for i in range(active_n):
        fp2, fp3, fv = (a.numpy() for a in tps.collect_p3p_instances(
            *(_t(a) for a in args), i, tp, **kw))
        np.testing.assert_array_equal(fv, tv[i])
        np.testing.assert_allclose(fp2[fv], tp2[i][fv], atol=1e-4)
        np.testing.assert_allclose(fp3[fv], tp3[i][fv], atol=1e-5)


# --------------------------------------------------------------------------
# the whole oracle window
# --------------------------------------------------------------------------

REFERENCE_EXACT = (
    "--pose_window_sweep seq --pose_collect_mode traced "
    "--depth_cost_mode projected --pose_sample_stride 1 "
    "--prior_sample_mode round"
)
BUDGET = "--n_poses_to_sample 2048 --depth_rand_samples 6"
PARITY_FX = 80.0  # tests/test_parity.py's camera
PARITY_SCENE = dict(  # tests/test_parity.py's forward_dominant scene
    planes=[(_norm([0.1, 0.15, 1.0]), 8.0), (_norm([-0.45, 0.1, 1.0]), 6.5),
            (_norm([0.3, -0.45, 1.0]), 7.0)],
    t=[0.1, 0.02, 0.45], seed=11,
)


def _parity_window(n_flows):
    sc = PARITY_SCENE
    rng = np.random.default_rng(sc["seed"])
    poses = np.zeros((n_flows, 6), np.float32)
    for f in range(n_flows):
        poses[f, :3] = rng.normal(0, 0.008, 3)
        poses[f, 3:6] = sc["t"]
    flows, depth0, Ts = render_window(K, poses, sc["planes"], H, W, _r2R)
    return flows, depth0, Ts


def _trajectory(poses6):
    """cam -> world transforms of the window's frames from its
    frame-to-frame poses."""
    T = np.eye(4)
    out = [np.linalg.inv(T)]
    for q in poses6:
        Tf = np.eye(4)
        Tf[:3, :3] = _r2R(q[:3])
        Tf[:3, 3] = q[3:6]
        T = Tf @ T
        out.append(np.linalg.inv(T))
    return np.stack(out)


def _mutual(ret_a, ret_b):
    """tests/test_parity.py's two readings: Sim3 ATE of A against B over
    B's extent, and the median gauge-normalised relative depth deviation."""
    from voldor_tpu.utils.evaluation import ate_rmse

    ta, tb = _trajectory(ret_a["poses"]), _trajectory(ret_b["poses"])
    extent = float(np.linalg.norm(tb[:, :3, 3] - tb[0, :3, 3], axis=1).max())
    ate = ate_rmse(ta, tb, with_scale=True) / max(extent, 1e-9)
    da = np.asarray(ret_a["depth"], np.float64)
    db = np.asarray(ret_b["depth"], np.float64)
    da = da * (np.median(db) / max(np.median(da), 1e-9))
    return ate, float(np.median(np.abs(da - db) / np.maximum(db, 1e-3)))


ORACLE_FLOWS = 4


@pytest.fixture(scope="module")
def oracle_port():
    flows, depth0, _ = _parity_window(ORACLE_FLOWS)
    args = (flows, PARITY_FX, PARITY_FX, W / 2, H / 2)
    cfg = f"--silent {BUDGET} {REFERENCE_EXACT}"
    ret = voldor_tpu_torch.voldor(*args, basefocal=40.0, config=cfg, device="cpu")
    fast = voldor_tpu_torch.voldor(*args, basefocal=40.0, config=f"--silent {BUDGET}", device="cpu")
    return dict(args=args, cfg=cfg, ret=ret, fast=fast, depth0=depth0)


def test_oracle_window_port_default_against_oracle(oracle_port):
    """One 4-flow oracle window of the parity scene through the port's
    voldor(): every transition registered; the shipped defaults within
    tests/test_parity.py's clean limits of it (mutual Sim3 ATE / extent <
    0.02, median relative depth deviation < 0.05), and the oracle's depth
    within 5% of the truth (median, mono gauge)."""
    ret, fast = oracle_port["ret"], oracle_port["fast"]
    assert ret["n_registered"] == ORACLE_FLOWS == fast["n_registered"]
    ate, drel = _mutual(fast, ret)
    print(f"port default vs port oracle: mutual ATE/extent {ate:.5f}, depth median rel {drel:.5f}")
    assert ate < 0.02 and drel < 0.05
    d0 = oracle_port["depth0"]
    d = ret["depth"] * (np.median(d0) / np.median(ret["depth"]))
    assert np.median(np.abs(d - d0)[8:-8, 8:-8] / d0[8:-8, 8:-8]) < 0.05


@pytest.mark.slow
def test_oracle_window_matches_jax_oracle(oracle_port):
    """The same oracle window through the JAX package's voldor() (cv2 on
    both sides): the port's oracle within the clean limits of the JAX
    package's oracle (mutual Sim3 ATE / extent < 0.02, median relative
    depth deviation < 0.05). Marked slow: the JAX package compiles its
    oracle solve, 17 s on the CPU."""
    ret_j = voldor_tpu.voldor(*oracle_port["args"], basefocal=40.0, config=oracle_port["cfg"])
    assert ret_j["n_registered"] == ORACLE_FLOWS
    ate, drel = _mutual(oracle_port["ret"], ret_j)
    print(f"port oracle vs JAX oracle: mutual ATE/extent {ate:.5f}, depth median rel {drel:.5f}")
    assert ate < 0.02 and drel < 0.05
