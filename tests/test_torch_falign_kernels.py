"""The falign kernels' plain versions (falign/residual.py:pair_normal_blocks,
pair_score_sums; ops/falign_kernels.py: lm_propose_reference,
lm_accept_reference, the steps of the chunk kernel's plain version) against
the JAX package, on the CPU, and the kernels against them on a CUDA device
(tests marked ``gpu``).

The JAX side runs op by op under ``jax.disable_jit()`` (compiled XLA
contracts multiply-adds into FMAs). Tolerances, those of
tests/test_torch_falign.py:
* the per-pair blocks (Jr^T Jr, Jr^T Jt, Jt^T Jt, Jr^T r, Jt^T r) within
  1e-4 of each block's largest entry, the cost 1/2 sum r^2 within 1e-5
  relative (the residuals agree within atol 1e-5); the lane's assembled H
  and g within 1e-4 of their largest entries; covariances within 2e-3
  relative at the same parameters; visible-pixel counts equal, the
  consistency scores within 1e-4;
* LM iterations from the same state: the step within 2e-3 of the largest
  parameter move, lam, the cost and w2 within 1e-4 relative, iteration
  counts and done flags equal;
  (covariances only where the frame's information matrix is conditioned
  below COV_COND);
* against the per-lane arithmetic (the per-pixel Jacobians reduced per
  lane at once, as the port computed them before the per-pair blocks): Jr^T Jr, the
  carried H and the covariances at the same parameters bitwise equal, the
  gradient and the cost within 1e-6 relative (their sums now run per
  pair, then over the pairs); whole solves with equal iteration counts,
  poses within 1e-4, scores within 1e-5 and covariance ranks equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from voldor_tpu.falign import residual as jres
from voldor_tpu.falign import solver as jsol
from voldor_tpu_torch.falign import api as tapi
from voldor_tpu_torch.falign import residual as tres
from voldor_tpu_torch.falign import solver as tsol
from voldor_tpu_torch.ops import falign_kernels as fk

from test_falign import CX, CY, FX, FY, H, W, TRUE_POSE, _make_pair
from test_torch_falign import _pairs_batch

CPU = torch.device("cpu")
VBF = FX * 5
BLOCKS = ("cost", "Hrr", "Hrt", "Htt", "gr", "gt")
# Covariances are held where the frame's information matrix is conditioned
# below this: the geometry-only 7-dof frames here reach 1e5-7e5, where the
# Jacobians' float32 rounding alone (the blocks agree within ~1e-6) moves
# the inverse by up to 5e-3; there the blocks' check holds the information.
COV_COND = 1e5


def _t(a, device=CPU):
    return torch.as_tensor(np.array(a, np.float32), device=device)


def _rel(a, b):
    """Largest |a - b| over each leading slice relative to that slice's
    largest |b|."""
    a = np.asarray(a, np.float64).reshape(len(b), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    return float((np.abs(a - b).max(1) / np.maximum(np.abs(b).max(1), 1e-30)).max())


@pytest.fixture(scope="module")
def frames():
    """Three keyframes of the wedge scene with seeded weights, and
    parameters off the truth with non-zero scale and colour terms."""
    depths, images = _make_pair(TRUE_POSE)
    d3, i3 = _make_pair(0.5 * TRUE_POSE)
    depths = np.concatenate([depths, d3[1:]])
    images = np.concatenate([images, i3[1:]])
    weights = np.random.default_rng(21).uniform(0.5, 1.0, depths.shape).astype(np.float32)
    params = np.zeros((3, 9), np.float32)
    params[0] = [0.02, -0.03, 0.01, 0.05, -0.02, 0.1, 0.04, 0.02, 1.5]
    params[1, :6] = TRUE_POSE + np.array([0.004, -0.003, 0.002, 0.03, -0.02, 0.02])
    params[1, 6:] = [-0.03, -0.01, -2.0]
    params[2, :6] = 0.5 * TRUE_POSE + np.array([-0.002, 0.003, 0.001, -0.02, 0.01, 0.015])
    params[2, 6:] = [0.02, 0.015, 0.8]
    return dict(depths=depths, images=images, weights=weights, params=params)


def _setup(frames, n, photo, dof7):
    """(port problem, JAX maps, pairs (np, 2), params (n, 9), dim mask) for
    the first n frames, fully connected."""
    tm = tres.precompute_maps(_t(frames["depths"][:n]), _t(frames["weights"][:n]),
                              _t(frames["images"][:n]), FX, FY, CX, CY)
    jm = jres.FrameMaps(packed=jnp.asarray(tm.packed.numpy()),
                        weights=jnp.asarray(frames["weights"][:n]))
    pairs = np.array([(r, t) for r in range(n) for t in range(n) if r != t], np.int32)
    dim_mask = tapi._dim_mask(n, dof7, photo)
    prob = tapi._problem(tm, pairs, n, FX, FY, CX, CY, VBF, 10.0, photo, dim_mask,
                         np.zeros((0, n * 9), np.float32), CPU)
    return prob, jm, pairs, frames["params"][:n], dim_mask


def _jintr():
    return tuple(jnp.float32(v) for v in (FX, FY, CX, CY))


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("dof7", [False, True])
@pytest.mark.parametrize("photo", [True, False])
@pytest.mark.parametrize("stride", [1, 4])
def test_linearize_plain_matches_jax(frames, stride, photo, dof7, n):
    """The linearise kernel's plain version: per-pair blocks against the JAX
    package's per-pixel Jacobians reduced in float64, the lane's normal
    equations against _joint_normal_eq; the covariances (from the Hrr
    block) against _pair_covariances; the scores mode against align_scores."""
    prob, jm, pairs, params, dim_mask = _setup(frames, n, photo, dof7)
    jargs = (jnp.asarray(params), jnp.asarray(pairs), jm, _jintr(), jnp.float32(VBF),
             jnp.float32(10.0), photo)
    with jax.disable_jit():
        res, Jr, Jt = jsol._pair_res_and_jacs(*jargs, stride, (H, W), jnp.asarray(dim_mask))
        Hj, gj = jsol._joint_normal_eq(res, Jr, Jt, jnp.asarray(pairs), n)
        cj, okj = jsol._pair_covariances(*jargs, stride, (H, W), jnp.asarray(dim_mask), n)
        visj, consj = jsol.align_scores(*jargs[:6], photo, jnp.float32(1.0), (H, W), stride=stride)
    P = len(pairs)
    r = np.asarray(res, np.float64).reshape(P, -1)
    Jr = np.asarray(Jr, np.float64).reshape(P, r.shape[1], 9)
    Jt = np.asarray(Jt, np.float64).reshape(P, r.shape[1], 9)
    ref = dict(cost=0.5 * (r * r).sum(1), Hrr=np.einsum("pki,pkj->pij", Jr, Jr),
               Hrt=np.einsum("pki,pkj->pij", Jr, Jt), Htt=np.einsum("pki,pkj->pij", Jt, Jt),
               gr=np.einsum("pki,pk->pi", Jr, r), gt=np.einsum("pki,pk->pi", Jt, r))

    p = _t(params)[None]
    lanes = torch.zeros(1, dtype=torch.int64)
    blk = tres.pair_normal_blocks(p, lanes, prob.pairs, prob.dim_mask, prob.maps, *prob.intr,
                                  prob.vbf, prob.crw, photo, stride)
    for name in BLOCKS:
        tol = 1e-5 if name == "cost" else 1e-4
        assert _rel(getattr(blk, name).numpy(), ref[name]) < tol, name
    cost, Ht, gt = fk.assemble(blk, prob.oh_r, prob.oh_t)
    np.testing.assert_allclose(float(cost[0]), ref["cost"].sum(), rtol=1e-5)
    Hj, gj = np.asarray(Hj), np.asarray(gj)
    np.testing.assert_allclose(Ht[0].numpy(), Hj, rtol=0, atol=1e-4 * np.abs(Hj).max())
    np.testing.assert_allclose(gt[0].numpy(), gj, rtol=0, atol=1e-4 * np.abs(gj).max())

    ct, okt = tsol.pair_covariances(prob, p, lanes, stride)
    cj = np.asarray(cj)
    np.testing.assert_array_equal(okt[0].numpy(), np.asarray(okj))
    for f in range(n):
        d = 7 if dof7 else 6
        if np.linalg.cond(cj[f, :d, :d].astype(np.float64)) < COV_COND:
            np.testing.assert_allclose(ct[0, f].numpy(), cj[f], rtol=2e-3,
                                       atol=2e-3 * np.abs(cj[f]).max(), err_msg=str(f))

    vis, cons = tsol.align_scores(prob, p, lanes, 1.0, stride)
    np.testing.assert_array_equal(vis[0].numpy(), np.asarray(visj))
    np.testing.assert_allclose(cons[0].numpy(), np.asarray(consj), rtol=0, atol=1e-4)
    n_vis, _ = tres.pair_score_sums(p, lanes, prob.pairs, prob.maps, *prob.intr, prob.vbf,
                                    prob.crw, photo, stride, torch.tensor(1.0))
    hs, ws = fk.grid_size(H, W, stride)
    np.testing.assert_array_equal(n_vis.numpy(), np.round(np.asarray(visj) * hs * ws))


# --------------------------------------------------------------------------
# the LM step
# --------------------------------------------------------------------------

PAIRS2 = np.asarray([[0, 1], [1, 0]], np.int32)


def _lm_setup(frames, dof7):
    photo = True
    tm = tres.precompute_maps(_t(frames["depths"][:2]), _t(frames["weights"][:2]),
                              _t(frames["images"][:2]), FX, FY, CX, CY)
    jm = jres.FrameMaps(packed=jnp.asarray(tm.packed.numpy()),
                        weights=jnp.asarray(frames["weights"][:2]))
    dim_mask = tapi._dim_mask(2, dof7, photo)
    gU = np.zeros((1 if dof7 else 0, 18), np.float32)
    if dof7:
        gU[0, 6] = gU[0, 15] = 1.0
    prob = tapi._problem(tm, PAIRS2, 2, FX, FY, CX, CY, VBF, 10.0, photo, dim_mask, gU, CPU)
    body, init_fn, _ = jsol._make_lm_step(
        jnp.asarray(PAIRS2), jm, _jintr(), jnp.float32(VBF), jnp.float32(10.0), photo, 2,
        (H, W), jnp.asarray(dim_mask), jnp.asarray(gU), 2)
    params = frames["params"][:2].copy()
    if not dof7:
        params[:, 6] = 0.0
    return prob, body, init_fn, params


def _jstate(st):
    """The port's one-lane state as the JAX body's tuple."""
    return (jnp.asarray(st.params[0].numpy()), jnp.float32(float(st.lam[0])),
            jnp.float32(float(st.cost[0])), jnp.asarray(st.H[0].numpy()),
            jnp.asarray(st.g[0].numpy()), jnp.int32(int(st.it[0])), jnp.bool_(bool(st.done[0])),
            jnp.float32(float(st.w2[0])))


@pytest.mark.parametrize("dof7", [False, True])
def test_lm_plain_matches_jax_over_iterations(frames, dof7):
    """Four LM iterations of the plain propose / linearise / accept from
    the state after init, against the JAX body applied four times from the
    same state."""
    prob, body, _, params = _lm_setup(frames, dof7)
    lanes = torch.zeros(1, dtype=torch.int64)
    st = tsol.phase_init(prob, _t(params)[None], lanes, 2)
    js = _jstate(st)
    p0 = params
    for k in range(4):
        with jax.disable_jit():
            js = body(js)
        st = tsol.lm_body(prob, st, lanes, 2)
        moved = np.abs(np.asarray(js[0]) - p0).max()  # 0 while every step is rejected
        np.testing.assert_allclose(st.params[0].numpy(), np.asarray(js[0]), rtol=0,
                                   atol=2e-3 * moved, err_msg=str(k))
        for a, b in ((st.lam[0], js[1]), (st.cost[0], js[2]), (st.w2[0], js[7])):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-4, err_msg=str(k))
        assert int(st.it[0]) == int(js[5]) == k + 1 and bool(st.done[0]) == bool(js[6])
    assert moved > 1e-3  # a real step was accepted


@pytest.mark.parametrize("case", ["rejected", "failed_factor"])
def test_lm_plain_matches_jax_on_reject_and_failed_factor(frames, case):
    """A step that cannot lower the carried cost is rejected (lam x 4, the
    state kept), and a system that is not positive definite fails its
    factor: the identity stands in (ok false) and the step is rejected."""
    prob, body, _, params = _lm_setup(frames, False)
    lanes = torch.zeros(1, dtype=torch.int64)
    st = tsol.phase_init(prob, _t(params)[None], lanes, 2)
    if case == "rejected":
        st = st._replace(cost=torch.zeros_like(st.cost))
    else:
        st = st._replace(H=-1e6 * torch.eye(18).expand(1, 18, 18).contiguous(),
                         g=torch.zeros_like(st.g))
    prop = fk.lm_propose_reference(prob, st, st.it + 1)
    assert bool(prop.info[0, 4] > 0) == (case == "rejected")  # the factor's ok flag
    with jax.disable_jit():
        js = body(_jstate(st))
    out = tsol.lm_body(prob, st, lanes, 2)
    for got, want in ((out.params, st.params), (out.cost, st.cost), (out.H, st.H), (out.g, st.g)):
        assert torch.equal(got, want)
    np.testing.assert_array_equal(np.asarray(js[0]), st.params[0].numpy())
    assert float(out.lam[0]) == float(js[1]) == pytest.approx(4e-3)
    assert bool(out.done[0]) == bool(js[6]) and int(out.it[0]) == int(js[5]) == 1


def test_lm_frozen_lanes_keep_their_state(frames):
    """A lane that is done, or whose it has reached it_end, is not
    advanced: every field of its state comes back unchanged."""
    prob, _, _, params = _lm_setup(frames, True)
    lanes = torch.zeros(1, dtype=torch.int64)
    st = tsol.phase_init(prob, _t(params)[None], lanes, 2)
    for frozen, it_end in ((st._replace(done=torch.ones_like(st.done)), st.it + 1),
                           (st, st.it)):
        out = tsol.lm_body(prob, frozen, lanes, 2, it_end)
        assert all(torch.equal(a, b) for a, b in zip(out, frozen))


# --------------------------------------------------------------------------
# against the per-lane arithmetic
# --------------------------------------------------------------------------


def _linearize_per_lane(prob, params, lanes, stride):
    """The per-lane linearize: the per-pixel Jacobians of every pair reduced
    per lane at once (the oracles _pair_res_and_jacs + _joint_normal_eq)."""
    res, Jr, Jt = tsol._pair_res_and_jacs(prob, params, lanes, stride)
    H, g = tsol._joint_normal_eq(res, Jr, Jt, prob.oh_r, prob.oh_t)
    return 0.5 * torch.sum(res * res, dim=(1, 2)), H, g


def _pair_covariances_per_lane(prob, params, lanes, stride):
    """pair_covariances with JrT Jr from the per-pixel Jacobians."""
    _, Jr, _ = tsol._pair_res_and_jacs(prob, params, lanes, stride)
    L, N = params.shape[0], prob.n_frames
    JtJ = torch.einsum("pn,lpij->lnij", prob.oh_r, torch.einsum("lpki,lpkj->lpij", Jr, Jr))
    Lc, info = torch.linalg.cholesky_ex(JtJ + torch.diag_embed(1.0 - prob.dim_mask))
    ok = (info == 0) & torch.isfinite(Lc).all(dim=(-2, -1))
    eye = torch.eye(9).expand(L, N, 9, 9)
    covars = torch.cholesky_solve(eye, torch.where(ok[..., None, None], Lc, eye))
    return torch.where(ok[..., None, None], covars, 0.0)


def _lm_body_per_lane(prob, st, lanes, stride, it_end=None):
    if it_end is None:
        it_end = st.it + 1
    prop = fk.lm_propose_reference(prob, st, it_end)
    return fk.accept_lanes(prob, st, prop, *_linearize_per_lane(prob, prop.trial, lanes, stride))


def test_linearisation_against_per_lane_arithmetic(frames):
    """Jr^T Jr per pair and the assembled H are the per-lane ones bitwise; the gradient
    and the cost, summed per pair and then over the pairs, within 1e-6."""
    prob, _, _, params, _ = _setup(frames, 3, True, True)
    p = _t(params)[None]
    lanes = torch.zeros(1, dtype=torch.int64)
    cost, Hn, gn = tsol.linearize(prob, p, lanes, 2)
    cost_l, H_l, g_l = _linearize_per_lane(prob, p, lanes, 2)
    assert torch.equal(Hn, H_l)
    _, Jr, _ = tsol._pair_res_and_jacs(prob, p, lanes, 2)
    Hrr = fk.linearize(prob, p, lanes, 2).Hrr
    assert torch.equal(Hrr, torch.einsum("lpki,lpkj->lpij", Jr, Jr).reshape(Hrr.shape))
    cov, ok = tsol.pair_covariances(prob, p, lanes, 2)
    assert torch.equal(cov, _pair_covariances_per_lane(prob, p, lanes, 2)) and bool(ok.all())
    np.testing.assert_allclose(gn.numpy(), g_l.numpy(), rtol=0, atol=1e-6 * float(g_l.abs().max()))
    np.testing.assert_allclose(cost.numpy(), cost_l.numpy(), rtol=1e-6)


@pytest.mark.parametrize("route", ["pairs", "falign"])
def test_solves_against_per_lane_arithmetic(monkeypatch, route):
    """falign_pairs (three lanes, coarse to fine) and falign (three frames,
    7-dof) on the CPU route, against the same calls with the per-lane
    linearize and LM body."""
    D, I, Wt, init = _pairs_batch()
    if route == "pairs":
        kw = dict(weights=Wt, images=I, poses_init=init, vbf=VBF, crw=10.0, optimize_7dof=True,
                  stride=2, coarse_stride=4, fine_iters=12, device="cpu")

        def run():
            return tapi.falign_pairs(D, FX, FY, CX, CY, **kw)
    else:
        d3, i3 = _make_pair(0.5 * TRUE_POSE)
        depths = np.concatenate([D[0], d3[1:]])
        init3 = np.zeros((3, 6), np.float32)
        init3[1], init3[2] = init[0, 1], 0.5 * TRUE_POSE

        def run():
            return [tapi.falign(depths, FX, FY, CX, CY, poses_init=init3, vbf=VBF,
                                optimize_7dof=True, stride=3, device="cpu")]
    new = run()
    monkeypatch.setattr(tsol, "linearize", _linearize_per_lane)
    monkeypatch.setattr(tsol, "lm_body", _lm_body_per_lane)
    old = run()
    for a, b in zip(new, old):
        assert (a.get("iters"), a.get("iters_coarse")) == (b.get("iters"), b.get("iters_coarse"))
        np.testing.assert_allclose(a["poses_ret"], b["poses_ret"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(a["scaling_factor"], b["scaling_factor"], rtol=1e-4)
        for k in ("visibility_mat", "consistency_mat"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5)
        # at (slightly) different parameters: the ranks the SLAM layer gates on
        np.testing.assert_array_equal(np.linalg.matrix_rank(a["poses_covar"].astype(np.float64)),
                                      np.linalg.matrix_rank(b["poses_covar"].astype(np.float64)))


# --------------------------------------------------------------------------
# the wrappers on the CPU
# --------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions(frames):
    """On the CPU the wrappers launch nothing; the kernel-only entry point
    refuses a CPU tensor."""
    prob, _, _, params, _ = _setup(frames, 2, True, True)
    p = _t(params)[None]
    lanes = torch.zeros(1, dtype=torch.int64)
    fk.reset_counts()
    st = tsol.phase_init(prob, p, lanes, 4)
    tsol.lm_iterate(prob, st, lanes, 4, 2)
    tsol.align_scores(prob, p, lanes, 1.0, 4)
    assert fk.read_counts() == dict(linearize=0, lm_chunk=0)
    with pytest.raises(ValueError, match="unsupported device"):
        fk.linearize_packed(prob, p, lanes, 4)


def test_gram_packing_round_trip(frames):
    """The kernels' packed layout, the 19 x 19 Gram matrix of [r, Jr, Jt]
    by rows a <= b, unpacks to the plain version's blocks."""
    prob, _, _, params, _ = _setup(frames, 3, True, True)
    blk = tres.pair_normal_blocks(_t(params)[None], torch.zeros(1, dtype=torch.int64),
                                  prob.pairs, prob.dim_mask, prob.maps, *prob.intr, prob.vbf,
                                  prob.crw, True, 4)
    B = blk.cost.shape[0]
    G = torch.zeros(B, 19, 19)
    G[:, 0, 0] = 2.0 * blk.cost
    G[:, 0, 1:10], G[:, 0, 10:] = blk.gr, blk.gt
    G[:, 1:10, 1:10], G[:, 1:10, 10:], G[:, 10:, 10:] = blk.Hrr, blk.Hrt, blk.Htt
    r, c = torch.triu_indices(19, 19)
    out = fk.unpack_blocks(G[:, r, c])
    sym = lambda a: torch.triu(a) + torch.triu(a, 1).transpose(-1, -2)  # noqa: E731
    for name in BLOCKS:
        want = getattr(blk, name)
        if name in ("Hrr", "Htt"):
            want = sym(want)
        assert torch.equal(getattr(out, name), want), name


# --------------------------------------------------------------------------
# the kernels (a CUDA device)
# --------------------------------------------------------------------------


def _card(frames):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the falign kernels have no CPU mode")
    prob, _, _, params, _ = _setup(frames, 3, True, True)
    dev = torch.device("cuda")
    maps = tres.FrameMaps(packed=prob.maps.packed.to(dev), weights=prob.maps.weights.to(dev))
    prob = tapi._problem(maps, prob.pairs.numpy(), 3, FX, FY, CX, CY, VBF, 10.0, True,
                         prob.dim_mask.numpy(), np.zeros((0, 27), np.float32), dev)
    return prob, _t(params, dev)[None], torch.zeros(1, dtype=torch.int64, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("stride", [1, 3, 4])
def test_linearize_kernel_matches_plain_on_gpu(frames, stride):
    prob, p, lanes = _card(frames)
    before = fk.linearize_launches
    kern = fk.linearize(prob, p, lanes, stride)
    assert fk.linearize_launches == before + 1
    plain = tres.pair_normal_blocks(p, lanes, prob.pairs, prob.dim_mask, prob.maps, *prob.intr,
                                    prob.vbf, prob.crw, True, stride)
    for name in BLOCKS:
        assert _rel(getattr(kern, name).cpu(), getattr(plain, name).cpu()) < 1e-4, name
    assert torch.equal(fk.linearize_packed(prob, p, lanes, stride),
                       fk.linearize_packed(prob, p, lanes, stride))
    n_vis, cons = fk.score_sums(prob, p, lanes, stride, 1.0)
    n_ref, c_ref = tres.pair_score_sums(p, lanes, prob.pairs, prob.maps, *prob.intr, prob.vbf,
                                        prob.crw, True, stride, torch.tensor(1.0, device="cuda"))
    assert torch.equal(n_vis, n_ref)
    np.testing.assert_allclose(cons.cpu().numpy(), c_ref.cpu().numpy(), rtol=1e-4)


@pytest.mark.gpu
def test_lm_kernels_match_plain_on_gpu(frames):
    """One LM iteration of the chunk kernel (n = 1) against the plain
    iteration from the same state."""
    prob, p, lanes = _card(frames)
    st = tsol.phase_init(prob, p, lanes, 2)
    before = fk.lm_chunk_launches
    sk = fk.lm_chunk(prob, st, lanes, 2, 1)
    assert fk.lm_chunk_launches == before + 1
    sp = fk.lm_chunk_reference(prob, st, lanes, 2, 1)
    step = (st.params - sp.params).abs().max()
    assert float((sk.params - sp.params).abs().max()) <= 2e-3 * float(step)
    assert torch.equal(sk.it, sp.it) and torch.equal(sk.done, sp.done)
    for name in ("params", "lam", "cost", "w2", "H", "g"):
        assert _rel(getattr(sk, name)[:, None].cpu(), getattr(sp, name)[:, None].cpu()) < 1e-4
