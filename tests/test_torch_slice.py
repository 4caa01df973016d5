"""The ported slice as a whole: one mono VO window through
``voldor_tpu_torch.voldor()`` against ``voldor_tpu.voldor()``, on the CPU.

* Whole window (the 72x96, n=3 scene of tests/test_em.py:223-247 with its
  reduced config), without priors and with one depth prior. cv2 is hidden
  on both sides, so both bootstrap through ops/epipolar.py. The JAX engine
  on the CPU does not take the batched kernel path (engine.py:366-373) and
  the random streams differ, so both packages are held to the same
  ground-truth gates instead of to each other: rotation atol 8e-3,
  translation atol 0.05 in the mono gauge, median relative depth error
  < 0.08.
* Mid-solve parity: a JAX engine state after init (with its prior-fusion
  round) is carried to the port with convert.window_state_from_numpy; one
  flow-fed depth round with the same uniforms on both sides agrees with the
  JAX harness round (tests/test_torch_em.py) on >= 99.9% of pixels.
* The port imports neither jax nor voldor_tpu.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import voldor_tpu
import voldor_tpu_torch
from voldor_tpu.config import VoldorConfig
from voldor_tpu.ops import lie as jlie
from voldor_tpu.vo import em as jem
from voldor_tpu.vo.engine import VoldorEngine as JEngine, fb_smooth_masked
from voldor_tpu_torch.convert import config_from_jax, em_params_from_numpy, window_state_from_numpy
from voldor_tpu_torch.ops import lie as tlie
from voldor_tpu_torch.vo import em as tem
from voldor_tpu_torch.vo.engine import _depth_round_core

from synthetic import render_window

H, W = 72, 96
K = np.array([[80.0, 0, 48.0], [0, 80.0, 36.0], [0, 0, 1]], np.float32)
CONFIG = ("--silent --max_iters 4 --n_poses_to_sample 2048 --depth_rand_samples 6 "
          "--depth_local_prop_width 16 --transfer_dtype float32")
INNER = np.s_[8:-8, 8:-8]


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


@pytest.fixture(scope="module")
def scene():
    n = 3
    poses = np.zeros((n, 6), np.float32)
    rng = np.random.default_rng(7)
    for f in range(n):
        poses[f, :3] = rng.normal(0, 0.01, 3)
        poses[f, 3:6] = [0.5 + 0.05 * rng.normal(), 0.05 * rng.normal(), 0.3]
    flows, depth0, _ = render_window(K, poses, PLANES, H, W, _r2R)
    s = n / np.linalg.norm(poses[:, 3:6], axis=1).sum()  # mono gauge: mean |t| = 1
    return dict(flows=flows, depth0=depth0, poses=poses, s=s)


def _check_gates(ret, sc):
    assert ret["n_registered"] == 3
    poses, s = sc["poses"], sc["s"]
    np.testing.assert_allclose(ret["poses"][:, :3], poses[:, :3], atol=8e-3)
    np.testing.assert_allclose(ret["poses"][:, 3:6], poses[:, 3:6] * s, atol=0.05)
    d_true = sc["depth0"][INNER] * s
    assert np.median(np.abs(ret["depth"][INNER] - d_true) / d_true) < 0.08
    assert np.all(np.isfinite(ret["depth_conf"]))


@pytest.mark.parametrize("with_prior", [False, True])
def test_whole_window_meets_gates_on_both_sides(scene, with_prior, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    kw = {}
    if with_prior:
        kw = dict(depth_priors=(scene["depth0"] * scene["s"])[None],
                  depth_prior_poses=np.zeros((1, 6), np.float32))
    args = (scene["flows"], 80.0, 80.0, 48.0, 36.0)
    ret_j = voldor_tpu.voldor(*args, basefocal=40.0, config=CONFIG, **kw)
    ret_t = voldor_tpu_torch.voldor(*args, basefocal=40.0, config=CONFIG, device="cpu", **kw)
    _check_gates(ret_j, scene)
    _check_gates(ret_t, scene)
    assert set(ret_t) == set(ret_j)
    for k in ret_j:
        assert np.shape(ret_t[k]) == np.shape(ret_j[k])


def test_mid_solve_depth_round_matches_jax(scene, monkeypatch):
    """JAX engine state after init (prior fusion) -> port; one anchored,
    flow-fed depth round with the prior arm and the same uniforms."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    cfg = VoldorConfig(fx=80.0, fy=80.0, cx=48.0, cy=36.0, basefocal=40.0)
    cfg.read_config(CONFIG)
    tcfg = config_from_jax(cfg)
    assert tcfg.to_string() == cfg.to_string()
    s = scene["s"]
    eng = JEngine(cfg).init(scene["flows"], depth_priors=(scene["depth0"] * s * 1.05)[None],
                            depth_prior_poses=np.zeros((1, 6), np.float32))
    poses6 = scene["poses"].copy()
    poses6[:, 3:6] *= s
    n = 3
    p = jem.EmParams.from_config(cfg, False)
    tp = em_params_from_numpy(p)
    emm, ncp = np.float32(cfg.fb_emm), np.float32(cfg.fb_no_change_prob)
    key = jax.random.PRNGKey(21)
    _, sub = jax.random.split(key)
    u = np.asarray(jax.random.uniform(sub, (6, H, W), jnp.float32))

    # the FB smoothing is a stable probability recurrence (no cancellation):
    # compiled is fine there, and op by op it would take most of the test
    rig = fb_smooth_masked(eng.rigidness, jnp.int32(n), emm, ncp)
    dpc = jem.fb_smooth(eng.dp_confs, emm, ncp)
    with jax.disable_jit():
        flows, depth = eng.flows, eng.depth
        Rs, ts = jlie.so3_exp(jnp.asarray(poses6[:, :3])), jnp.asarray(poses6[:, 3:6])
        dp_Rs, dp_ts = jlie.so3_exp(eng.dp_poses6[:, :3]), eng.dp_poses6[:, 3:6]
        track, tinb = jem.precompute_obs_tracks(flows, jnp.int32(n), p)
        pr = jem.precompute_prior_samples(depth, eng.priors, eng.dp_pconfs, eng.dp_confs, dp_Rs, dp_ts, p)

        def batch_cost_fn(cands):
            return jax.vmap(lambda c: jem.compute_cost_map_tracked(
                c, track, tinb, rig, Rs, ts, pr, jnp.int32(n), p))(cands)

        d_j, c_j = jem.optimize_depth_batched(
            depth, batch_cost_fn(depth[None])[0], batch_cost_fn, sub, n_rand_samples=6,
            global_prop_step=8, local_prop_width=16, range_factor=1.0)
        rig_j, track_j, tinb_j = jem.update_rigidness_and_tracks(d_j, flows, Rs, ts, jnp.int32(n), p)

    st = window_state_from_numpy(dict(
        depth=np.asarray(depth), flows=np.asarray(flows), rigidness=np.asarray(eng.rigidness),
        poses6=poses6, priors=np.asarray(eng.priors), dp_pconfs=np.asarray(eng.dp_pconfs),
        dp_confs=np.asarray(eng.dp_confs), dp_poses6=np.asarray(eng.dp_poses6),
        track_x=np.asarray(track[0]), track_y=np.asarray(track[1]), obs_x=np.asarray(track[2]),
        obs_y=np.asarray(track[3]), tinb=np.asarray(tinb),
    ))
    t_dp_Rs = tlie.so3_exp(st.dp_poses6[:, :3])
    t_pr = tem.precompute_prior_samples(st.depth, st.priors, st.dp_pconfs, st.dp_confs,
                                        t_dp_Rs, st.dp_poses6[:, 3:6], tp)
    d_t, rig_t, dpc_t, track_t, tinb_t = _depth_round_core(
        st.depth, st.flows, st.rigidness, st.poses6, st.priors, st.dp_pconfs, st.dp_confs,
        st.dp_poses6, n, tp, torch.as_tensor(u), cfg.fb_emm, cfg.fb_no_change_prob, 1.0,
        gstep=8, lwidth=16, mode="jump", fb=True, rig_only=False, use_flows=True,
        use_priors=True, tracked=True, anchored=True, obs_track=st.track, obs_tinb=st.tinb,
        prior_samples=t_pr, freeze_prior_confs=True,
    )
    same_depth = np.isclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5, atol=1e-5)
    assert same_depth.mean() >= 0.999, same_depth.mean()
    np.testing.assert_allclose(dpc_t.numpy(), np.asarray(dpc), rtol=1e-5, atol=1e-5)
    same_rig = np.isclose(rig_t.numpy(), np.asarray(rig_j), rtol=1e-5, atol=1e-5)
    assert same_rig.mean() >= 0.999, same_rig.mean()
    np.testing.assert_array_equal(tinb_t.numpy()[:, same_depth], np.asarray(tinb_j)[:, same_depth])
    # the round pulled the 5%-off prior depth toward the truth
    d_true = scene["depth0"][INNER] * s
    assert np.median(np.abs(d_t.numpy()[INNER] - d_true) / d_true) < 0.05


def test_port_imports_no_jax():
    code = (
        "import sys, voldor_tpu_torch, voldor_tpu_torch.convert, voldor_tpu_torch.vo.api, "
        "voldor_tpu_torch.utils.evaluation, voldor_tpu_torch.slam.system, "
        "voldor_tpu_torch.ops.covis, voldor_tpu_torch.utils.flow_io, voldor_tpu_torch.ops._build, "
        "voldor_tpu_torch.ops.fb_smooth, voldor_tpu_torch.ops.cost, voldor_tpu_torch.falign.api, "
        "voldor_tpu_torch.pgo.api, voldor_tpu_torch.pgo.reduce, voldor_tpu_torch.pgo.g2o; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'voldor_tpu' or m.startswith('voldor_tpu.')]; "
        "assert not bad, bad; print('clean')"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=root, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
