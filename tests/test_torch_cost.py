"""The cost kernel's module (voldor_tpu_torch/ops/cost.py) against the JAX
package, on the CPU.

On CPU tensors ``cost_map_score`` runs its plain version; it is held
against the vmapped ``em.compute_cost_map_tracked`` (the case of
tests/test_pallas_cost.py: 32x128, N=4, K=3), with the fused depth-prior arm
at D=1 and D=2 (including the disparity slot, em.py:317-319), and the raw
sums against the Pallas kernel itself in interpret mode at one tiny shape.
Tolerance: elementwise rtol = atol = 1e-5 and an identical +inf pattern.
The plain accept, ``accept_reference``, is held bitwise to the accept of
``em.optimize_depth_batched`` on scripted costs (ties, masks, all-+inf
pixels, NaNs). The kernel itself runs only on a CUDA device (tests marked
``gpu``).

The JAX side runs op by op (``jax.disable_jit``): compiled, XLA on the CPU
contracts ``a*b + c`` into fused multiply-adds and divides by constants
through a reciprocal, so its projections differ from IEEE-rounded ones in
the last bit. The cost near the optimum is a difference of nearly equal
projections, and the Fisk density turns that last bit into ~1e-2 relative
cost differences (the CUDA kernel is built with --fmad=false for the same
reason). Run op by op, both packages round every step the same way.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from voldor_tpu.config import VoldorConfig
from voldor_tpu.ops import lie as jlie
from voldor_tpu.ops.pallas_cost import cost_map_tracked_pallas
from voldor_tpu.vo import em as jem
from voldor_tpu_torch.convert import em_params_from_numpy
from voldor_tpu_torch.ops import cost as tcost
from voldor_tpu_torch.vo import em as tem

from synthetic import plane_depth, render_window

TOL = dict(rtol=1e-5, atol=1e-5)


def _n(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


PLANES = [(_n([0.1, 0.15, 1.0]), 8.0), (_n([-0.4, 0.1, 1.0]), 6.5)]


def _r2R(rv):
    return np.asarray(jlie.so3_exp(jnp.asarray(np.asarray(rv, np.float32))))


def _case(h, w, n, disparity=False):
    """Scene planes, tracks, rigidness and priors computed by the JAX
    package; returned as numpy so both sides get identical inputs."""
    K = np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(2)
    poses = np.zeros((n, 6), np.float32)
    for f in range(n):
        poses[f, :3] = rng.normal(0, 0.01, 3)
        poses[f, 3:6] = [0.35, 0.02, 0.15]
    flows, depth0, Ts = render_window(K, poses, PLANES, h, w, _r2R)
    cfg = VoldorConfig(fx=40.0, fy=40.0, cx=w / 2, cy=h / 2, basefocal=20.0)
    p = jem.EmParams.from_config(cfg, disparity)
    Rs = np.stack([_r2R(q[:3]) for q in poses])
    ts = poses[:, 3:6]
    depth1 = plane_depth(K, Ts[1][:3, :3], Ts[1][:3, 3], PLANES, h, w)
    priors = np.stack([depth0 * 1.02, depth1]).astype(np.float32)
    dp_poses = np.stack([np.zeros(6, np.float32), poses[0]])
    pconfs = rng.uniform(0.5, 1.0, (2, h, w)).astype(np.float32)
    confs = rng.uniform(0.0, 1.0, (2, h, w)).astype(np.float32)
    cands = np.stack([depth0, depth0 * 1.2, np.full((h, w), 5.0, np.float32)]).astype(np.float32)
    return dict(flows=flows, depth0=depth0, p=p, Rs=Rs, ts=ts, priors=priors,
                dp_Rs=np.stack([_r2R(q[:3]) for q in dp_poses]), dp_ts=dp_poses[:, 3:6],
                pconfs=pconfs, confs=confs, cands=cands)


def _jax_planes(c, active_n, D):
    p = c["p"]
    fl = jnp.asarray(c["flows"])
    Rs, ts = jnp.asarray(c["Rs"]), jnp.asarray(c["ts"])
    rig = jem.update_rigidness(jnp.asarray(c["depth0"]), fl, Rs, ts, jnp.int32(active_n), p)
    track, tinb = jem.precompute_obs_tracks(fl, jnp.int32(active_n), p)
    ps = None
    if D:
        ps = jem.precompute_prior_samples(
            jnp.asarray(c["depth0"]), jnp.asarray(c["priors"][:D]), jnp.asarray(c["pconfs"][:D]),
            jnp.asarray(c["confs"][:D]), jnp.asarray(c["dp_Rs"][:D]), jnp.asarray(c["dp_ts"][:D]), p,
        )
    return rig, track, tinb, ps


def _to_torch(rig, track, tinb, ps, c):
    def t(a):
        return torch.as_tensor(np.array(a))

    tps = None if ps is None else tuple(t(a) for a in ps)
    return (t(rig), tuple(t(a) for a in track), t(tinb), t(c["Rs"]), t(c["ts"]), tps)


def _assert_cost_equal(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], ref[finite], **TOL)


@pytest.mark.parametrize(
    "active_n,D,disparity",
    [(4, 0, False), (2, 0, False), (4, 1, False), (4, 2, True), (2, 2, False)],
)
def test_cost_map_tracked_matches_jax(active_n, D, disparity):
    c = _case(32, 128, 4, disparity)
    with jax.disable_jit():
        rig, track, tinb, ps = _jax_planes(c, active_n, D)
        ref = jax.vmap(
            lambda d: jem.compute_cost_map_tracked(
                d, track, tinb, rig, jnp.asarray(c["Rs"]), jnp.asarray(c["ts"]), ps,
                jnp.int32(active_n), c["p"],
            )
        )(jnp.asarray(c["cands"]))
    trig, ttrack, ttinb, tRs, tts, tps = _to_torch(rig, track, tinb, ps, c)
    got = tcost.cost_map_score(
        torch.as_tensor(c["cands"]), ttrack, ttinb, trig, tRs, tts, active_n,
        em_params_from_numpy(c["p"]), prior_samples=tps,
    )
    _assert_cost_equal(got, ref)
    if disparity:  # the disparity slot really weighs differently
        assert float(c["p"].disp_delta) > 0


def test_cost_map_tracked_matches_pallas_interpret():
    """Raw sums against the Pallas kernel itself (interpret mode), both arms.

    The interpret mode compiles the kernel body even under disable_jit, so
    it carries XLA's fused rounding (module note): on these inputs it
    differs from the JAX package's own op-by-op em.compute_cost_map_tracked
    by up to 1.2e-4 relative away from the exact depth, and by ~1e-2 at it.
    Hence candidates away from the exact depth and rtol = atol = 2e-4 here;
    the port meets 1e-5 against the op-by-op reference above."""
    c = _case(8, 128, 2)
    cands = c["cands"][1:]
    with jax.disable_jit():
        rig, track, tinb, ps = _jax_planes(c, 2, 1)
        cs_j, ws_j = cost_map_tracked_pallas(
            jnp.asarray(cands), track, tinb, rig, jnp.asarray(c["Rs"]), jnp.asarray(c["ts"]),
            jnp.int32(2), c["p"], prior_samples=ps, interpret=True,
        )
    trig, ttrack, ttinb, tRs, tts, tps = _to_torch(rig, track, tinb, ps, c)
    cs_t, ws_t = tcost.cost_map_tracked_reference(
        torch.as_tensor(cands), ttrack, ttinb, trig, tRs, tts, 2,
        em_params_from_numpy(c["p"]), prior_samples=tps,
    )
    np.testing.assert_allclose(cs_t.numpy(), np.asarray(cs_j), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ws_t.numpy(), np.asarray(ws_j), **TOL)


def test_cost_wrapper_takes_plain_version_on_cpu():
    """The wrappers pick the plain versions by device alone: CPU tensors never
    touch the kernel or its counters; other devices raise."""
    c = _case(8, 128, 2)
    rig, track, tinb, ps = _jax_planes(c, 2, 1)
    trig, ttrack, ttinb, tRs, tts, tps = _to_torch(rig, track, tinb, ps, c)
    before = (tcost.cost_kernel_launches, tcost.cost_score_launches)
    cands = torch.as_tensor(c["cands"][:2])
    planes = (ttrack, ttinb, trig, tRs, tts, 2, em_params_from_numpy(c["p"]))
    costs = tcost.normalize_cost(*tcost.cost_map_tracked_reference(cands, *planes, prior_samples=tps))
    assert torch.equal(tcost.cost_map_score(cands, *planes, prior_samples=tps), costs)
    depth = torch.as_tensor(c["depth0"] * 1.1)
    cost = torch.full_like(depth, 5.0)
    masks = torch.ones(cands.shape, dtype=torch.bool)
    masks[1, :, ::2] = False
    d, k = tcost.cost_map_accept(depth, cost, cands, masks, *planes, prior_samples=tps)
    d_ref, k_ref = tcost.accept_reference(depth, cost, costs, cands, masks)
    assert torch.equal(d, d_ref) and torch.equal(k, k_ref)
    assert (tcost.cost_kernel_launches, tcost.cost_score_launches) == before
    assert torch.equal(depth, torch.as_tensor(c["depth0"] * 1.1))  # inputs untouched
    with pytest.raises(ValueError):
        tcost.cost_map_score(torch.zeros((2, 8, 128), device="meta"), *planes)


def _scripted_costs(kind, h, w, sizes, seed):
    """One (K, h, w) cost stack per accept call of a batched depth round."""
    rng = np.random.default_rng(seed)
    out = []
    for k in sizes:
        if kind == "ties":  # few distinct values: most pixels tie somewhere
            c = rng.choice(np.float32([0.5, 1.0, 1.5]), (k, h, w))
        else:
            c = rng.uniform(0.2, 3.0, (k, h, w)).astype(np.float32)
        if kind == "masks":  # the lowest costs fall where the masks are off
            c[:, :, :2] = 0.01
            c[:, :2, :] = 0.01
        if kind == "all_inf":
            c[:, ::3, :] = np.inf
        if kind == "nan":  # NaN beside lower and higher costs of other k
            c[rng.integers(0, k), ::2, ::3] = np.nan
            c[:, 5:9, 5:9] = np.nan
        out.append(c.astype(np.float32))
    return out


@pytest.mark.parametrize("kind", ["ties", "masks", "all_inf", "nan"])
def test_accept_reference_matches_jax_accept(kind):
    """A batched depth round of jem.optimize_depth_batched with a scripted
    batch_cost_fn against the port's round with accept_reference on the
    same costs: every accepted depth and cost is identical."""
    h, w, n_rand, gstep, lwidth = 16, 24, 5, 4, 8
    sizes = [n_rand, 4] + [4] * 3  # random, global, jump offsets 1, 2, 4
    costs = _scripted_costs(kind, h, w, sizes, seed=["ties", "masks", "all_inf", "nan"].index(kind))
    rng = np.random.default_rng(11)
    depth0 = rng.uniform(1.0, 9.0, (h, w)).astype(np.float32)
    cost0 = rng.uniform(0.5, 2.5, (h, w)).astype(np.float32)
    cost0[::4, ::5] = np.inf
    key = jax.random.PRNGKey(5)
    u = np.array(jax.random.uniform(key, (n_rand, h, w), jnp.float32))

    calls = iter(costs)

    def batch_cost_fn(cands):
        c = next(calls)
        assert c.shape == cands.shape
        return jnp.asarray(c)

    with jax.disable_jit():
        d_j, c_j = jem.optimize_depth_batched(
            jnp.asarray(depth0), jnp.asarray(cost0), batch_cost_fn, key, n_rand_samples=n_rand,
            global_prop_step=gstep, local_prop_width=lwidth, range_factor=1.0,
        )
    assert next(calls, None) is None
    calls = iter(costs)

    def accept_fn(depth, cost, cands, masks):
        c = torch.as_tensor(next(calls))
        assert c.shape == cands.shape
        return tcost.accept_reference(depth, cost, c, cands, masks)

    d_t, c_t = tem.optimize_depth_batched(
        torch.as_tensor(depth0), torch.as_tensor(cost0), accept_fn, torch.as_tensor(u),
        global_prop_step=gstep, local_prop_width=lwidth, range_factor=1.0,
    )
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    assert not np.array_equal(d_t.numpy(), depth0)  # the round did accept something


def test_accept_reference_semantics():
    """The four rules on one pixel each (K = 3, current cost 1.0)."""
    cands = torch.tensor([[[1.0, 1.0, 1.0, 1.0]], [[2.0, 2.0, 2.0, 2.0]], [[3.0, 3.0, 3.0, 3.0]]])
    inf, nan = float("inf"), float("nan")
    costs = torch.tensor([
        [[0.5, 0.2, inf, 0.3]],
        [[0.5, 0.1, inf, nan]],
        [[0.4, 0.1, inf, 0.1]],
    ])
    masks = torch.ones_like(cands, dtype=torch.bool)
    masks[1, 0, 1] = False  # the lowest cost of pixel 1 is masked out
    d, c = tcost.accept_reference(torch.zeros(1, 4), torch.ones(1, 4), costs, cands, masks)
    # pixel 0: the strict minimum (k=2); pixel 1: k=2, the masked k=1 never
    # wins; pixel 2: all +inf keeps the pixel; pixel 3: the NaN wins the
    # argmin, so nothing is accepted
    assert d.tolist() == [[3.0, 3.0, 0.0, 0.0]]
    np.testing.assert_array_equal(c.numpy(), np.float32([[0.4, 0.1, 1.0, 1.0]]))
    masks[:] = True
    d, _ = tcost.accept_reference(torch.zeros(1, 4), torch.ones(1, 4), costs, cands, masks)
    assert d[0, 1] == 2.0  # unmasked, the tie 0.1 goes to the lower k


def _gpu_planes():
    c = _case(32, 128, 4)
    rig, track, tinb, ps = _jax_planes(c, 3, 2)
    dev = torch.device("cuda")
    trig, ttrack, ttinb, tRs, tts, tps = (
        x.to(dev) if isinstance(x, torch.Tensor) else tuple(y.to(dev) for y in x)
        for x in _to_torch(rig, track, tinb, ps, c)
    )
    planes = (ttrack, ttinb, trig, tRs, tts, 3, em_params_from_numpy(c["p"]))
    return c, dev, planes, tps


@pytest.mark.gpu
def test_cost_kernel_matches_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cost kernel has no CPU mode")
    c, dev, planes, tps = _gpu_planes()
    cands = torch.as_tensor(c["cands"], device=dev)
    before = tcost.cost_kernel_launches
    got = tcost.cost_map_score(cands, *planes, prior_samples=tps)
    assert tcost.cost_kernel_launches == before + 1
    ref = tcost.normalize_cost(*tcost.cost_map_tracked_reference(cands, *planes, prior_samples=tps))
    _assert_cost_equal(got.cpu(), ref.cpu())


@pytest.mark.gpu
def test_cost_kernel_accept_matches_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cost kernel has no CPU mode")
    c, dev, planes, tps = _gpu_planes()
    cands = torch.as_tensor(c["cands"], device=dev)
    masks = torch.ones(cands.shape, dtype=torch.bool, device=dev)
    masks[0, :, ::3] = False
    depth = torch.as_tensor(c["depth0"] * 1.3, device=dev)
    cost = tcost.cost_map_score(depth[None].contiguous(), *planes, prior_samples=tps)[0]
    costs = tcost.normalize_cost(*tcost.cost_map_tracked_reference(cands, *planes, prior_samples=tps))
    d_ref, c_ref = tcost.accept_reference(depth, cost, costs, cands, masks)
    d, k = tcost.cost_map_accept(depth.clone(), cost.clone(), cands, masks, *planes, prior_samples=tps)
    same = d == d_ref
    assert same.float().mean().item() >= 0.999
    # the written cost: the plain one where the depths agree, and everywhere
    # the plain cost of the kernel's own pick (the old cost where it kept
    # the pixel), which is a near-tie with the plain pick's
    assert torch.equal(torch.isinf(k[same]), torch.isinf(c_ref[same]))
    assert _close(k[same], c_ref[same]).all()
    hit = (cands == d[None]) & masks
    took = hit.any(dim=0) & ((d != depth) | (k != cost))
    pick = torch.where(took, torch.gather(costs, 0, torch.argmax(hit.to(torch.uint8), 0)[None])[0], cost)
    assert _close(k, pick).all() and _close(pick, c_ref).all()


def _close(a, b):
    """Equal (+inf to +inf), within 1e-5 + 1e-5 * |b| of a finite b, or both NaN."""
    near = (torch.abs(a - b) <= 1e-5 + 1e-5 * torch.abs(b)) & torch.isfinite(b)
    return (a == b) | near | (torch.isnan(a) & torch.isnan(b))
