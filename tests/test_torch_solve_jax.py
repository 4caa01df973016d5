"""The port's EM solve loop and one flow-fed depth round against the JAX
package on the same inputs, on the CPU.

The full solve (``engine._solve_loop``: camera sweeps with truncation,
depth rounds, gauge normalisation) runs mono, without priors, from a given
depth and poses, as the JAX package's ``parallel/mesh.py:multichip_solve``
runs its solve on one device: on tests/test_multichip.py's geometrically
consistent window, whole (32 rows) and cut to 30 rows. Both sides pad the
rows to a multiple of 8 with inert rows (flow 0, depth 0, rigidness 0) and
crop them back. Their P4P and meanshift draws differ, so both are held to
the rendered poses and to each other.

The depth round (``_depth_round_core``) runs on the 30-row window padded
to 32: the JAX round with its Pallas cost kernel in interpret mode (as
tests/test_pallas_cost.py runs it), the port's with the kernels' plain
versions, from the same uniforms.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import render_window
from voldor_tpu.config import VoldorConfig
from voldor_tpu.ops import pallas_cost as jpallas
from voldor_tpu.parallel import mesh as jmesh
from voldor_tpu.vo import em as jem
from voldor_tpu.vo import engine as jengine
from voldor_tpu_torch.convert import config_from_jax, em_params_from_numpy
from voldor_tpu_torch.ops import lie
from voldor_tpu_torch.vo import em
from voldor_tpu_torch.vo.engine import _depth_round_core, _solve_loop, depth_kw, pose_hp

N, W = 3, 128
ROW_BLOCK = 8  # the JAX package pads the rows to a multiple of this
SEED = 21


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


def _rendered_poses():
    """_consistent_window's relative poses."""
    rng = np.random.default_rng(5)
    poses = np.zeros((N, 6), np.float32)
    for f in range(N):
        poses[f, :3] = rng.normal(0, 0.004, 3)
        poses[f, 3:6] = [0.1, 0.01, 0.3]
    return poses


def _consistent_window(h, focal=40.0):
    """test_multichip.py's geometrically consistent two-plane window."""
    K = np.array([[focal, 0, W / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)
    planes = [(_n([0.1, 0.15, 1.0]), 8.0), (_n([-0.35, 0.1, 1.0]), 6.5)]
    flows, depth0, _ = render_window(K, _rendered_poses(), planes, h, W, _r2R)
    return flows, depth0


def _cfg(h, max_iters=None):
    cfg = VoldorConfig(fx=40.0, fy=40.0, cx=W / 2, cy=h / 2, basefocal=20.0)
    cfg.n_poses_to_sample = 512
    cfg.depth_rand_samples = 2
    cfg.depth_local_prop_width = 8
    if max_iters is not None:
        cfg.max_iters = max_iters
    return cfg


def _poses0():
    p = np.zeros((N, 6), np.float32)
    p[:, 5] = 0.3
    return p


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-3)


# --------------------------------------------------------------------------
# the full solve
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[32, 30], ids=["h32", "h30"])
def jax_solve(request):
    """tests/test_multichip.py's full solve on one device of the JAX
    package: 2 EM iterations on the consistent 32 x 128 window, and on its
    first 30 rows, which it pads to 32 with inert rows."""
    h = request.param
    flows, depth0 = _consistent_window(h)
    cfg = _cfg(h, max_iters=2)
    st = jmesh.multichip_solve(jmesh.make_mesh(1), cfg, flows, depth0, _poses0())
    return dict(flows=flows, depth0=depth0, cfg=cfg,
                **{k: np.asarray(st[k], np.float64) for k in ("poses6", "depth", "rigidness")})


def _port_solve(cfg, flows, depth0):
    """The port's solve loop from depth0 and _poses0(), mono, no priors,
    the rows padded to a multiple of ROW_BLOCK with inert rows and the
    depth and rigidness cropped back."""
    flows, depth = torch.as_tensor(flows), torch.as_tensor(depth0)
    h = flows.shape[1]
    pad = -h % ROW_BLOCK
    rigidness = torch.ones((N, h, W))
    flows = torch.nn.functional.pad(flows, (0, 0, 0, 0, 0, pad))
    depth = torch.nn.functional.pad(depth, (0, 0, 0, pad))
    rigidness = torch.nn.functional.pad(rigidness, (0, 0, 0, pad))
    gen = torch.Generator()
    gen.manual_seed(int(cfg.seed))
    z0 = torch.zeros((0, h + pad, W))
    st = _solve_loop(
        cfg, em.EmParams.from_config(cfg, False), pose_hp(cfg), depth_kw(cfg), gen,
        depth, flows, rigidness, z0, z0, z0, torch.zeros((0, 6)), torch.as_tensor(_poses0()),
        torch.zeros((N, 6, 6)), torch.zeros(N), torch.zeros(N, dtype=torch.int32), N,
    )
    return st["poses6"], st["depth"][:h], st["rigidness"][:, :h]


def test_solve_loop_matches_jax(jax_solve):
    """The port's solve against the JAX package's and the rendered poses
    (in the solve's mono gauge). Limits: poses within atol 2e-4 of the
    truth and of the JAX solve (measured at most 3.5e-5 and 3.2e-5; the
    JAX multichip test's KITTI-shape bound is 5e-3); depth and rigidness
    max relative error to the JAX solve < 0.05 (the JAX multichip tests'
    dense bound; measured at most 6.0e-3 and 2.7e-2)."""
    j = jax_solve
    tcfg = config_from_jax(j["cfg"])
    assert tcfg.to_string() == j["cfg"].to_string()
    poses6, depth, rigidness = _port_solve(tcfg, j["flows"], j["depth0"])
    truth = _rendered_poses().astype(np.float64)  # in the solve's mono gauge:
    truth[:, 3:] /= np.linalg.norm(truth[:, 3:], axis=1).mean()  # mean |t| = 1
    for poses in (poses6.numpy(), j["poses6"]):
        np.testing.assert_allclose(poses, truth, rtol=0, atol=2e-4)
    np.testing.assert_allclose(poses6.numpy(), j["poses6"], rtol=0, atol=2e-4)
    for k, v in (("depth", depth), ("rigidness", rigidness)):
        assert v.shape == j[k].shape
        assert _rel(v.numpy(), j[k]).max() < 0.05, k


# --------------------------------------------------------------------------
# one depth round
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def padded_round():
    """A 30-row window padded to 32 rows with inert rows (flow 0, depth 0,
    rigidness 0), as the solve pads it, from a start depth 20% off the
    truth; the JAX round's result and its uniforms."""
    h, hp = 30, 32
    flows, depth0 = _consistent_window(h)
    start = depth0 * np.random.default_rng(7).uniform(0.8, 1.25, depth0.shape).astype(np.float32)
    flows = np.pad(flows, ((0, 0), (0, hp - h), (0, 0), (0, 0)))
    depth = np.pad(start, ((0, hp - h), (0, 0)))
    rig = np.pad(np.ones((N, h, W), np.float32), ((0, 0), (0, hp - h), (0, 0)))
    poses = _rendered_poses()
    cfg = _cfg(h)
    p = jem.EmParams.from_config(cfg, False)
    # the JAX round draws its uniforms from split(PRNGKey(seed))[1]
    # (engine.py:156, em.py:613)
    sub = jax.random.split(jax.random.PRNGKey(SEED))[1]
    u = np.asarray(jax.random.uniform(sub, (cfg.depth_rand_samples, hp, W), jnp.float32))
    z0 = jnp.zeros((0, hp, W), jnp.float32)
    mp = pytest.MonkeyPatch()
    mp.setattr(jpallas, "cost_map_tracked_pallas",
               functools.partial(jpallas.cost_map_tracked_pallas, interpret=True))
    try:
        d_j, r_j, _ = jengine._depth_round_core(
            jnp.asarray(depth), jnp.asarray(flows), jnp.asarray(rig), jnp.asarray(poses),
            z0, z0, z0, jnp.zeros((0, 6), jnp.float32), jnp.int32(N), p, np.uint32(SEED),
            jnp.float32(cfg.fb_emm), jnp.float32(cfg.fb_no_change_prob),
            jnp.float32(cfg.depth_range_factor), n_rand=cfg.depth_rand_samples,
            gstep=cfg.depth_global_prop_step, lwidth=cfg.depth_local_prop_width,
            mode=cfg.depth_local_prop_mode, fb=True, rig_only=False, use_flows=True,
            use_priors=False, tracked=True, use_pallas=True,
        )
    finally:
        mp.undo()
    return dict(h=h, flows=flows, depth=depth, rig=rig, poses=poses, cfg=cfg, p=p, u=u,
                depth0=depth0, d_j=np.asarray(d_j), r_j=np.asarray(r_j))


def test_depth_round_matches_jax(padded_round):
    """The port's round (both kernels' plain versions) against the JAX
    round. Limits: depth within rtol / atol 1e-5 at >= 99.9% of pixels (as
    test_torch_slice's mid-solve round; measured: all, max 7.6e-6);
    rigidness max relative error < 0.05 (the JAX multichip tests' dense
    bound) and >= 99.9% of entries within atol 1e-3 (measured 9.2e-3 and
    99.98%: the refresh's exp / log round apart on this window's
    near-exact residuals, as the JAX package's own jitted refresh is 4.8e-3
    from its op-by-op one). The padded rows stay inert: depth 0 on both."""
    r = padded_round
    cfg, h = r["cfg"], r["h"]
    tz = torch.zeros((0,) + r["depth"].shape)
    d_t, r_t, _ = _depth_round_core(
        torch.tensor(r["depth"]), torch.tensor(r["flows"]), torch.tensor(r["rig"]),
        torch.tensor(r["poses"]), tz, tz, tz, torch.zeros((0, 6)), N,
        em_params_from_numpy(r["p"]), torch.tensor(r["u"]), cfg.fb_emm,
        cfg.fb_no_change_prob, cfg.depth_range_factor,
        gstep=cfg.depth_global_prop_step, lwidth=cfg.depth_local_prop_width,
        mode=cfg.depth_local_prop_mode, fb=True, rig_only=False, use_flows=True,
        use_priors=False, tracked=True,
    )
    d_t, r_t = d_t.numpy(), r_t.numpy()
    d_j, r_j = r["d_j"], r["r_j"]
    assert np.isclose(d_t, d_j, rtol=1e-5, atol=1e-5).mean() >= 0.999
    assert _rel(r_t, r_j).max() < 0.05
    assert np.isclose(r_t, r_j, rtol=0, atol=1e-3).mean() >= 0.999
    assert np.all(d_t[h:] == 0) and np.all(d_j[h:] == 0)
    # the round did work: most pixels moved, toward the truth
    assert (d_t != r["depth"]).mean() > 0.5
    err = np.median(np.abs(d_t[:h] - r["depth0"]) / r["depth0"])
    assert err < 0.25 * np.median(np.abs(r["depth"][:h] - r["depth0"]) / r["depth0"])
