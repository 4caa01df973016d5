"""One flow-fed depth round of the port on row bands against the JAX
package's, on the CPU (the full solve is in
tests/test_torch_parallel_jax.py).

The round (``_depth_round_core``) runs on the consistent window cut to 30
rows and padded to 32 with inert rows, as multichip_solve pads it: the JAX
round with its Pallas cost kernel in interpret mode (as
tests/test_pallas_cost.py runs it), the port's on a mesh of one and on
sp = 4 row bands (both kernels' plain versions, band by band), from the
same uniforms.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parallel import _consistent_window, _rel
from test_torch_parallel_jax import MESHES, N, W, _cfg, _rendered_poses
from voldor_tpu.ops import pallas_cost as jpallas
from voldor_tpu.vo import em as jem
from voldor_tpu.vo import engine as jengine
from voldor_tpu_torch.convert import em_params_from_numpy
from voldor_tpu_torch.parallel.hints import active_mesh
from voldor_tpu_torch.vo.engine import _depth_round_core

SEED = 21


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def padded_round():
    """A 30-row window padded to 32 rows with inert rows (flow 0, depth 0,
    rigidness 0), as multichip_solve pads it, from a start depth 20% off
    the truth; the JAX round's result and its uniforms."""
    h, hp = 30, 32
    flows, depth0 = _consistent_window(N, h, W)
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


@pytest.mark.parametrize("mesh", ["one", "sp4"])
def test_depth_round_on_padded_bands_matches_jax(padded_round, mesh):
    """The port's round (both kernels' plain versions, per band on sp4)
    against the JAX round. Limits: depth within rtol / atol 1e-5 at >= 99.9%
    of pixels (as test_torch_slice's mid-solve round; measured: all, max
    7.6e-6); rigidness max relative error < 0.05 (the JAX multichip tests'
    dense bound) and >= 99.9% of entries within atol 1e-3 (measured 9.2e-3
    and 99.98%: the refresh's exp / log round apart on this window's
    near-exact residuals, as the JAX package's own jitted refresh is 4.8e-3
    from its op-by-op one). The padded rows stay inert: depth 0 on both."""
    r = padded_round
    cfg, h = r["cfg"], r["h"]
    tz = torch.zeros((0,) + r["depth"].shape)
    args = (torch.tensor(r["depth"]), torch.tensor(r["flows"]), torch.tensor(r["rig"]),
            torch.tensor(r["poses"]), tz, tz, tz, torch.zeros((0, 6)), N,
            em_params_from_numpy(r["p"]), torch.tensor(r["u"]), cfg.fb_emm,
            cfg.fb_no_change_prob, cfg.depth_range_factor)
    with active_mesh(MESHES[mesh]()):
        d_t, r_t, _ = _depth_round_core(
            *args, gstep=cfg.depth_global_prop_step, lwidth=cfg.depth_local_prop_width,
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
