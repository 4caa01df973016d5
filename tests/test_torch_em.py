"""The EM depth side of the PyTorch port (voldor_tpu_torch/vo/em.py) against
the JAX package, on the CPU.

Inputs come from the 72x96 three-plane window of tests/test_em.py. The JAX
side runs op by op (``jax.disable_jit``) so both packages round every step
the same way (see tests/test_torch_cost.py). Elementwise tolerance rtol =
atol = 1e-5 (track positions: atol 1e-4, they are ~100 px). Depth rounds
take the JAX side's own uniforms; their depth and cost must agree on at
least 99.9% of pixels: a per-pixel argmin between candidates whose costs
tie to float rounding may pick the other one.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from voldor_tpu.config import VoldorConfig
from voldor_tpu.ops import lie as jlie
from voldor_tpu.vo import em as jem
from voldor_tpu_torch.convert import em_params_from_numpy
from voldor_tpu_torch.ops import cost as tcost
from voldor_tpu_torch.vo import em as tem

from synthetic import plane_depth, render_window

H, W = 72, 96
K = np.array([[80.0, 0, 48.0], [0, 80.0, 36.0], [0, 0, 1]], np.float32)
TOL = dict(rtol=1e-5, atol=1e-5)


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


@pytest.fixture(scope="module")
def win():
    n = 3
    poses = np.zeros((n, 6), np.float32)
    rng = np.random.default_rng(7)
    for f in range(n):
        poses[f, :3] = rng.normal(0, 0.01, 3)
        poses[f, 3:6] = [0.5 + 0.05 * rng.normal(), 0.05 * rng.normal(), 0.2]
    flows, depth0, Ts = render_window(K, poses, PLANES, H, W, _r2R)
    cfg = VoldorConfig(fx=80.0, fy=80.0, cx=48.0, cy=36.0, basefocal=40.0)
    p = jem.EmParams.from_config(cfg, has_disparity=False)
    Rs = np.stack([_r2R(q[:3]) for q in poses])
    depth1 = plane_depth(K, Ts[1][:3, :3], Ts[1][:3, 3], PLANES, H, W)
    dp_poses = np.stack([np.zeros(6, np.float32), poses[0]])
    return dict(
        flows=flows, depth0=depth0, poses=poses, p=p, tp=em_params_from_numpy(p), Rs=Rs,
        ts=poses[:, 3:6], priors=np.stack([depth0 * 1.03, depth1]).astype(np.float32),
        dp_Rs=np.stack([_r2R(q[:3]) for q in dp_poses]), dp_ts=dp_poses[:, 3:6],
        pconfs=rng.uniform(0.5, 1.0, (2, H, W)).astype(np.float32),
        confs=rng.uniform(0.2, 1.0, (2, H, W)).astype(np.float32),
    )


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("active_n", [3, 2])
def test_precompute_obs_tracks_matches_jax(win, active_n):
    with jax.disable_jit():
        (tx, ty, ox, oy), inb = jem.precompute_obs_tracks(jnp.asarray(win["flows"]), jnp.int32(active_n), win["p"])
    (ttx, tty, tox, toy), tinb = tem.precompute_obs_tracks(_t(win["flows"]), active_n, win["tp"])
    np.testing.assert_array_equal(tinb.numpy(), np.asarray(inb))
    for a, b in ((ttx, tx), (tty, ty)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)
    for a, b in ((tox, ox), (toy, oy)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("scale", [1.0, 1.1])
def test_update_rigidness_and_tracks_matches_jax(win, scale):
    depth = (win["depth0"] * scale).astype(np.float32)
    with jax.disable_jit():
        rig, (px, py, ox, oy), inb = jem.update_rigidness_and_tracks(
            *_j(depth, win["flows"], win["Rs"], win["ts"]), jnp.int32(3), win["p"]
        )
        rig_only = jem.update_rigidness(*_j(depth, win["flows"], win["Rs"], win["ts"]), jnp.int32(2), win["p"])
    trig, (tpx, tpy, tox, toy), tinb = tem.update_rigidness_and_tracks(
        _t(depth), _t(win["flows"]), _t(win["Rs"]), _t(win["ts"]), 3, win["tp"]
    )
    np.testing.assert_array_equal(tinb.numpy(), np.asarray(inb))
    np.testing.assert_allclose(trig.numpy(), np.asarray(rig), **TOL)
    np.testing.assert_allclose(tpx.numpy(), np.asarray(px), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tpy.numpy(), np.asarray(py), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tox.numpy(), np.asarray(ox), **TOL)
    trig2 = tem.update_rigidness(_t(depth), _t(win["flows"]), _t(win["Rs"]), _t(win["ts"]), 2, win["tp"])
    np.testing.assert_allclose(trig2.numpy(), np.asarray(rig_only), **TOL)
    assert np.all(trig2.numpy()[2:] == 0)


@pytest.mark.parametrize("disparity", [False, True])
def test_prior_samples_and_confs_match_jax(win, disparity):
    cfg = VoldorConfig(fx=80.0, fy=80.0, cx=48.0, cy=36.0, basefocal=40.0)
    p = jem.EmParams.from_config(cfg, has_disparity=disparity)
    tp = em_params_from_numpy(p)
    depth = (win["depth0"] * 1.01).astype(np.float32)
    args = (depth, win["priors"], win["pconfs"], win["confs"], win["dp_Rs"], win["dp_ts"])
    with jax.disable_jit():
        tgt, wgt, _, _ = jem.precompute_prior_samples(*_j(*args), p)
        confs = jem.update_prior_confs(*_j(depth, win["priors"], win["confs"], win["dp_Rs"], win["dp_ts"]), p)
    ttgt, twgt, _, _ = tem.precompute_prior_samples(*map(_t, args), tp)
    np.testing.assert_allclose(ttgt.numpy(), np.asarray(tgt), **TOL)
    np.testing.assert_allclose(twgt.numpy(), np.asarray(wgt), **TOL)
    tconfs = tem.update_prior_confs(*map(_t, (depth, win["priors"], win["confs"], win["dp_Rs"], win["dp_ts"])), tp)
    np.testing.assert_allclose(tconfs.numpy(), np.asarray(confs), **TOL)


def _agree(a, b, frac=0.999):
    a, b = np.asarray(a), np.asarray(b)
    same = np.isclose(a, b, rtol=1e-5, atol=1e-5) | (np.isinf(a) & np.isinf(b))
    assert same.mean() >= frac, f"agree on {same.mean():.5f} of pixels"


@pytest.mark.parametrize("with_priors", [False, True])
def test_optimize_depth_batched_matches_jax(win, with_priors):
    """One batched depth round with the JAX side's uniforms; the JAX
    reference is the harness of tests/test_em.py:259-264, the port side
    scores and accepts through ops/cost.py as the engine does."""
    p, tp = win["p"], win["tp"]
    key = jax.random.PRNGKey(3)
    n_rand, gstep, lwidth = 6, 8, 16
    depth0 = np.full((H, W), 2.5, np.float32)
    u = np.asarray(jax.random.uniform(key, (n_rand, H, W), jnp.float32))
    with jax.disable_jit():
        rig = jem.update_rigidness(*_j(win["depth0"], win["flows"], win["Rs"], win["ts"]), jnp.int32(3), p)
        track, tinb = jem.precompute_obs_tracks(jnp.asarray(win["flows"]), jnp.int32(3), p)
        ps = None
        if with_priors:
            ps = jem.precompute_prior_samples(
                *_j(depth0, win["priors"], win["pconfs"], win["confs"], win["dp_Rs"], win["dp_ts"]), p)
        Rs, ts = _j(win["Rs"], win["ts"])

        def batch_cost_fn(cands):
            return jax.vmap(lambda c: jem.compute_cost_map_tracked(
                c, track, tinb, rig, Rs, ts, ps, jnp.int32(3), p))(cands)

        d_j = jnp.asarray(depth0)
        c_j = batch_cost_fn(d_j[None])[0]
        d_j, c_j = jem.optimize_depth_batched(
            d_j, c_j, batch_cost_fn, key, n_rand_samples=n_rand,
            global_prop_step=gstep, local_prop_width=lwidth, range_factor=1.0,
        )
    ttrack = tuple(_t(a) for a in track)
    tps = None if ps is None else tuple(_t(a) for a in ps)
    trig, ttinb, tRs, tts = _t(rig), _t(tinb), _t(win["Rs"]), _t(win["ts"])

    planes = (ttrack, ttinb, trig, tRs, tts, 3, tp)

    def taccept(depth, cost, cands, masks):  # the engine's wiring (vo/engine.py)
        return tcost.cost_map_accept(depth, cost, cands, masks, *planes, prior_samples=tps)

    d_t = _t(depth0)
    c_t = tcost.cost_map_score(d_t[None], *planes, prior_samples=tps)[0]
    d_t, c_t = tem.optimize_depth_batched(
        d_t, c_t, taccept, _t(u), global_prop_step=gstep, local_prop_width=lwidth, range_factor=1.0
    )
    _agree(d_t.numpy(), d_j)
    _agree(c_t.numpy(), c_j)
    # the round really moved the depth toward the truth
    assert np.median(np.abs(d_t.numpy() - win["depth0"]) / win["depth0"]) < 0.5


def test_optimize_depth_jump_matches_jax(win):
    """The one-map-at-a-time round (prior-only fusion round of engine.init),
    with the per-proposal uniforms of em.py:493-497 rebuilt from the key."""
    p, tp = win["p"], win["tp"]
    key = jax.random.PRNGKey(9)
    n_rand, gstep, lwidth = 4, 8, 8
    depth0 = (win["priors"][0]).astype(np.float32)
    u = np.stack([np.asarray(jax.random.uniform(k, (H, W), jnp.float32))
                  for k in jax.random.split(key, n_rand)])
    with jax.disable_jit():
        ps = jem.precompute_prior_samples(
            *_j(depth0, win["priors"], win["pconfs"], win["confs"], win["dp_Rs"], win["dp_ts"]), p)

        def cost_fn(d):
            return jem.compute_cost_map_tracked(d, None, None, None, None, None, ps, jnp.int32(0), p)

        d_j = jnp.asarray(depth0)
        d_j, c_j = jem.optimize_depth(
            d_j, cost_fn(d_j), None, None, None, None, None, None, None, None, None,
            jnp.int32(0), p, key, n_rand_samples=n_rand, global_prop_step=gstep,
            local_prop_width=lwidth, range_factor=1.0, local_prop_mode="jump", cost_fn=cost_fn,
        )
    tps = tuple(_t(a) for a in ps)

    def tcost_fn(d):
        return tem.compute_cost_map_tracked(d, None, None, None, None, None, tps, 0, tp)

    d_t = _t(depth0)
    d_t, c_t = tem.optimize_depth(
        d_t, tcost_fn(d_t), tcost_fn, _t(u), global_prop_step=gstep, local_prop_width=lwidth,
        range_factor=1.0, local_prop_mode="jump",
    )
    _agree(d_t.numpy(), d_j)
    _agree(c_t.numpy(), c_j)
