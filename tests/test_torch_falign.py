"""Frame alignment of the port (voldor_tpu_torch/falign, the ops/lie and
ops/image additions) against the JAX package, on the CPU.

Tolerances, and why:
* Lie maps, packed sampling, blur, precompute_maps: atol 1e-6 (same
  float32 formula; the blur also within 1e-5 of cv2.GaussianBlur up to
  ksize 7).
* Residuals and the analytic Jacobian at the same parameters on the same
  maps: residual atol 1e-5, Jacobian 1e-4 of its largest entry (XLA fuses
  and reorders the chain rule's products). The JAX package pads its maps to
  8 x 128 (a TPU workaround, residual.py:72-80); a tar query in the last
  half texel of a padded axis then reads the padded column's normal, so
  the residual-level tests hand the JAX functions the unpadded maps.
  precompute_maps itself agrees on the logical frame, its right and
  bottom borders included.
* One LM body step from the same state: the step within 2e-3 of its
  largest entry (the damped 18 x 18 solve amplifies the last bits of H),
  the trial's cost within 1e-4 relative, its H and g within 1e-3 of their
  largest entries.
* Whole solves: the LM on these scenes is sensitive to the last bit
  (near the optimum the sqrt-Cauchy robustifier switches pixels between
  its two branches), so the JAX package itself moves by about as much when
  its init moves by 1e-6. Held: equal iteration counts, the relative pose
  within 1e-5 (6-dof) / 1e-3 (7-dof), the scale ratio within 1e-4, the
  scores within 1e-4, covariances within 2e-3 relative at the same
  parameters, and the rank-deficient lane (zero weights) reported the same.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from voldor_tpu.falign import api as japi
from voldor_tpu.falign import residual as jres
from voldor_tpu.falign import solver as jsol
from voldor_tpu.ops import image as jimage
from voldor_tpu.ops import lie as jlie
from voldor_tpu_torch.falign import api as tapi
from voldor_tpu_torch.falign import residual as tres
from voldor_tpu_torch.falign import solver as tsol
from voldor_tpu_torch.ops import image as timage
from voldor_tpu_torch.ops import lie as tlie
from voldor_tpu_torch.ops.lie import pose6_to_T44

from test_falign import CX, CY, FX, FY, TRUE_POSE, _make_pair

CPU = torch.device("cpu")


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


# --------------------------------------------------------------------------
# ops/lie and ops/image additions
# --------------------------------------------------------------------------


def _rvecs(rng):
    r = rng.normal(0, 0.8, (64, 3)).astype(np.float32)
    r[:8] *= 1e-7  # the small-angle branches
    r[8] = 0.0
    return r


@pytest.mark.parametrize("fn", ["rotate_rvec", "so3_right_jacobian", "quat_from_rvec",
                                "quat_mul", "quat_conj", "quat_rotate"])
def test_lie_additions_match_jax(fn):
    rng = np.random.default_rng(5)
    r = _rvecs(rng)
    p = rng.normal(0, 3, (64, 3)).astype(np.float32)
    q = np.asarray(jlie.quat_normalize(jnp.asarray(rng.normal(size=(64, 4)).astype(np.float32))))
    q2 = np.asarray(jlie.quat_normalize(jnp.asarray(rng.normal(size=(64, 4)).astype(np.float32))))
    args = {"rotate_rvec": (p, r), "so3_right_jacobian": (r,), "quat_from_rvec": (r,),
            "quat_mul": (q, q2), "quat_conj": (q,), "quat_rotate": (q, p)}[fn]
    j = np.asarray(getattr(jlie, fn)(*map(jnp.asarray, args)))
    t = getattr(tlie, fn)(*map(_t, args)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


def test_forward_mode_through_small_angle_branches():
    """jacfwd at rvec = 0 steps over the 0/0 of the branch not taken: the
    port's forward-mode Jacobians of quat_from_rvec and rotate_rvec there
    are finite and equal JAX's."""
    p = np.asarray([0.3, -1.2, 2.0], np.float32)
    z = np.zeros(3, np.float32)
    for jf, tf in ((jlie.quat_from_rvec, tlie.quat_from_rvec),
                   (lambda r: jlie.rotate_rvec(jnp.asarray(p), r),
                    lambda r: tlie.rotate_rvec(_t(p), r))):
        j = np.asarray(jax.jacfwd(jf)(jnp.asarray(z)))
        t = torch.func.jacfwd(tf)(_t(z)).numpy()
        assert np.isfinite(t).all()
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


def _queries(rng, h, w, n=400):
    """Query points inside, outside and near (not on) the borders."""
    x = rng.uniform(-3, w + 2, n).astype(np.float32)
    y = rng.uniform(-3, h + 2, n).astype(np.float32)
    x[:20] = w - 1 - rng.uniform(1e-3, 0.5, 20)
    y[20:40] = h - 1 - rng.uniform(1e-3, 0.5, 20)
    x[40:60] = rng.uniform(1e-3, 0.5, 20)
    return x, y


@pytest.mark.parametrize("grad", [False, True])
def test_packed_sample_matches_jax(grad):
    rng = np.random.default_rng(9)
    h, w = 13, 17
    img = rng.normal(size=(h, w, 5)).astype(np.float32)
    x, y = _queries(rng, h, w)
    jf = jimage.bilinear_sample_packed_grad if grad else jimage.bilinear_sample_packed
    tf = timage.bilinear_sample_packed_grad if grad else timage.bilinear_sample_packed
    j = jf(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    t = tf(_t(img), _t(x), _t(y))
    for a, b in zip(t if grad else [t], j if grad else [j]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    # the rows form: query b reads map rows[b] of a stack, as the residual
    # samples its tar frames
    stack = rng.normal(size=(3, h, w, 5)).astype(np.float32)
    rows = np.asarray([2, 0, 2, 1])
    xb, yb = x[:240].reshape(4, 60), y[:240].reshape(4, 60)
    tb = tf(_t(stack), _t(xb), _t(yb), rows=torch.as_tensor(rows))
    for i, r in enumerate(rows):
        ji = jf(jnp.asarray(stack[r]), jnp.asarray(xb[i]), jnp.asarray(yb[i]))
        for a, b in zip(tb if grad else [tb], ji if grad else [ji]):
            np.testing.assert_allclose(a[i].numpy(), np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("ksize", [3, 5, 7, 9])
def test_gaussian_blur_matches_jax_and_cv2(ksize):
    rng = np.random.default_rng(ksize)
    img = rng.uniform(0, 10, (23, 31)).astype(np.float32)
    np.testing.assert_allclose(timage.cv2_gaussian_kernel(ksize).numpy(),
                               np.asarray(jimage.cv2_gaussian_kernel(ksize)), rtol=0, atol=1e-7)
    t = timage.gaussian_blur(_t(img), ksize).numpy()
    np.testing.assert_allclose(t, np.asarray(jimage.gaussian_blur(jnp.asarray(img), ksize)),
                               rtol=0, atol=1e-5)
    try:
        import cv2
    except ImportError:
        cv2 = None
    # the JAX SLAM layer's _gblur takes cv2 where it imports. It agrees up to
    # ksize 7 (the local links blur at 3 and 5); at 9 (the loop-closure image
    # blur) OpenCV's own fixed taps differ from the sigma formula that both
    # packages follow (ROADMAP C)
    if cv2 is not None and ksize <= 7:
        np.testing.assert_allclose(t, cv2.GaussianBlur(img, (ksize, ksize), 0), rtol=0, atol=1e-5)


def test_precompute_maps_matches_jax_at_the_padded_borders():
    """61 x 90: the JAX package pads to 64 x 128. On the logical frame, its
    last row and column included, the maps agree."""
    rng = np.random.default_rng(2)
    depths = rng.uniform(3, 9, (2, 61, 90)).astype(np.float32)
    weights = rng.uniform(0, 1, (2, 61, 90)).astype(np.float32)
    images = rng.uniform(0, 1, (2, 61, 90)).astype(np.float32)
    jm, bounds = jres.precompute_maps(jnp.asarray(depths), jnp.asarray(weights),
                                      jnp.asarray(images), FX, FY, CX, CY)
    tm = tres.precompute_maps(_t(depths), _t(weights), _t(images), FX, FY, CX, CY)
    assert bounds == tm.bounds == (61, 90) and np.asarray(jm.packed).shape[1:3] == (64, 128)
    np.testing.assert_allclose(tm.packed.numpy(), np.asarray(jm.packed)[:, :61, :90],
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tm.weights.numpy(), np.asarray(jm.weights)[:, :61, :90])


# --------------------------------------------------------------------------
# residual, Jacobian, one LM step
# --------------------------------------------------------------------------

PAIRS2 = np.asarray([[0, 1], [1, 0]], np.int32)


@pytest.fixture(scope="module")
def wedge():
    depths, images = _make_pair(TRUE_POSE)
    weights = np.full_like(depths, 0.7)
    tm = tres.precompute_maps(_t(depths), _t(weights), _t(images), FX, FY, CX, CY)
    # the JAX functions get the same, unpadded maps (module docstring)
    jm = jres.FrameMaps(packed=jnp.asarray(tm.packed.numpy()), weights=jnp.asarray(weights))
    params = np.zeros((2, 9), np.float32)
    params[0] = [0.02, -0.03, 0.01, 0.05, -0.02, 0.1, 0.04, 0.02, 1.5]
    params[1] = [-0.01, 0.02, 0.03, -0.06, 0.01, -0.08, -0.03, -0.01, -2.0]
    return dict(depths=depths, images=images, tm=tm, jm=jm, params=params)


def _tprob(tm, photo, dim_mask, gauge_U=None, crw=10.0):
    return tapi._problem(tm, PAIRS2, 2, FX, FY, CX, CY, FX * 5, crw, photo, dim_mask,
                         np.zeros((0, 18), np.float32) if gauge_U is None else gauge_U, CPU)


def _jintr():
    return tuple(jnp.float32(v) for v in (FX, FY, CX, CY))


@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("photo", [True, False])
def test_residual_and_jacobian_match_jax(wedge, photo, stride):
    dim_mask = np.ones((2, 9), np.float32)
    h, w = wedge["depths"].shape[1:]
    args = (jnp.asarray(wedge["params"]), jnp.asarray(PAIRS2), wedge["jm"], _jintr(),
            jnp.float32(FX * 5), jnp.float32(10.0), photo, stride, (h, w), jnp.asarray(dim_mask))
    r_j, Jr_j, Jt_j = map(np.asarray, jsol._pair_res_and_jacs(*args))
    prob = _tprob(wedge["tm"], photo, dim_mask)
    lanes = torch.zeros(1, dtype=torch.int64)
    p = _t(wedge["params"])[None]
    r_t, Jr_t, Jt_t = (a.numpy().reshape(b.shape) for a, b in
                       zip(tsol._pair_res_and_jacs(prob, p, lanes, stride), (r_j, Jr_j, Jt_j)))
    scale = max(np.abs(Jr_j).max(), np.abs(Jt_j).max())
    np.testing.assert_allclose(r_t, r_j, rtol=0, atol=1e-5)
    assert np.abs(Jr_t - Jr_j).max() / scale < 1e-4
    assert np.abs(Jt_t - Jt_j).max() / scale < 1e-4
    # the residual map itself, with and without weights
    for aw in (True, False):
        rj, vj = jres.pair_residual_map(*(jnp.asarray(wedge["params"][i]) for i in (0, 1)), 0, 1,
                                        wedge["jm"], FX, FY, CX, CY, FX * 5, 10.0, photo, stride,
                                        (h, w), apply_weights=aw)
        rt, vt = tres.pair_residual_map(p[0, :1], p[0, 1:], torch.tensor([0]), torch.tensor([1]),
                                        wedge["tm"], *prob.intr, prob.vbf, prob.crw, photo,
                                        stride, apply_weights=aw)
        np.testing.assert_array_equal(vt[0].numpy(), np.asarray(vj))
        np.testing.assert_allclose(rt[0].numpy(), np.asarray(rj), rtol=0, atol=1e-5)
    # the analytic chain rule against the port's forward-mode oracle
    r_a, Jr_a, Jt_a = (a.numpy().reshape(b.shape) for a, b in
                       zip(tsol._pair_res_and_jacs_ad(prob, p, lanes, stride), (r_j, Jr_j, Jt_j)))
    assert np.abs(r_a - r_t).max() < 1e-3
    assert np.abs(Jr_a - Jr_t).max() / scale < 2e-3
    assert np.abs(Jt_a - Jt_t).max() / scale < 2e-3


@pytest.mark.parametrize("dof7", [False, True])
def test_one_lm_step_matches_jax(wedge, dof7):
    """The LM body from the same state (the state after init on the same
    maps): the same trial, accept decision, damping and carried system."""
    photo = True
    dim_mask = tapi._dim_mask(2, dof7, photo)
    gU = np.zeros((1 if dof7 else 0, 18), np.float32)
    if dof7:
        gU[0, 6] = gU[0, 15] = 1.0
    h, w = wedge["depths"].shape[1:]
    params = wedge["params"].copy()
    params[:, 6:] = 0.0
    body, init_fn, _ = jsol._make_lm_step(
        jnp.asarray(PAIRS2), wedge["jm"], _jintr(), jnp.float32(FX * 5), jnp.float32(10.0),
        photo, 2, (h, w), jnp.asarray(dim_mask), jnp.asarray(gU), 2)
    cost0, H0, g0 = init_fn(jnp.asarray(params))
    state = (jnp.asarray(params), jnp.float32(1e-3), cost0, H0, g0, jnp.int32(0),
             jnp.bool_(False), jnp.float32(0.0))
    jout = jax.jit(body)(state)

    prob = _tprob(wedge["tm"], photo, dim_mask, gU)
    lanes = torch.zeros(1, dtype=torch.int64)
    st = tsol.phase_init(prob, _t(params)[None], lanes, 2)
    np.testing.assert_allclose(float(st.cost[0]), float(cost0), rtol=1e-5)
    np.testing.assert_allclose(st.H[0].numpy(), np.asarray(H0), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(H0)).max())
    tout = tsol.lm_body(prob, st, lanes, 2)
    step = np.abs(np.asarray(jout[0]) - params).max()
    assert step > 1e-3  # a real step was taken and accepted
    np.testing.assert_allclose(tout.params[0].numpy(), np.asarray(jout[0]), rtol=0,
                               atol=2e-3 * step)
    for a, b in ((tout.lam[0], jout[1]), (tout.cost[0], jout[2]), (tout.w2[0], jout[7])):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4)
    # the carried system, linearized at the (slightly different) trial
    np.testing.assert_allclose(tout.H[0].numpy(), np.asarray(jout[3]), rtol=0,
                               atol=1e-3 * np.abs(np.asarray(jout[3])).max())
    np.testing.assert_allclose(tout.g[0].numpy(), np.asarray(jout[4]), rtol=0,
                               atol=1e-3 * np.abs(np.asarray(jout[4])).max())
    assert bool(tout.done[0]) == bool(jout[6]) and int(tout.it[0]) == int(jout[5]) == 1


def test_lm_iterations_make_no_host_round_trip(wedge):
    """On a card, each of these ops syncs with the host: a Python value
    stored into a tensor (aten::lift_fresh), a value read back
    (aten::_local_scalar_dense, aten::nonzero) and a batched cholesky_solve.
    None may run inside a chunk of LM iterations: the lanes' done flags are
    read once per chunk, by solve_lanes."""
    from torch.profiler import ProfilerActivity, profile

    dim_mask = tapi._dim_mask(2, True, True)
    gU = np.zeros((1, 18), np.float32)
    gU[0, 6] = gU[0, 15] = 1.0
    prob = _tprob(wedge["tm"], True, dim_mask, gU)
    lanes = torch.zeros(1, dtype=torch.int64)
    st = tsol.phase_init(prob, _t(wedge["params"])[None], lanes, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = tsol.lm_iterate(prob, st, lanes, 2, 3)
    names = {e.name for e in prof.events()}
    assert int(out.it[0]) == 3 and "aten::linalg_cholesky_ex" in names
    assert not names & {"aten::lift_fresh", "aten::_local_scalar_dense", "aten::nonzero",
                        "aten::cholesky_solve"}


# --------------------------------------------------------------------------
# whole solves
# --------------------------------------------------------------------------


def _rel(poses6):
    T = pose6_to_T44(_t(poses6)).numpy().astype(np.float64)
    return [np.linalg.inv(T[0]) @ T[k] for k in range(1, len(T))]


def _third_frame():
    """A third keyframe of the wedge scene, between the two of _make_pair."""
    d3, i3 = _make_pair(0.5 * TRUE_POSE)
    return d3[1], i3[1]


CASES = {
    "geo-6dof": dict(n=2, photo=False, dof7=False),
    "photo-6dof": dict(n=2, photo=True, dof7=False),
    "geo-7dof": dict(n=2, photo=False, dof7=True),
    "geo-3frames": dict(n=3, photo=False, dof7=False),
    "photo-3frames-subset": dict(n=3, photo=True, dof7=False, conn=[0, 1, 2, 1, 0, 2, -1]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_falign_matches_jax(case, monkeypatch):
    c = CASES[case]
    depths, images = _make_pair(TRUE_POSE)
    init = np.zeros((c["n"], 6), np.float32)
    init[1] = TRUE_POSE + np.array([0.004, -0.003, 0.002, 0.03, -0.02, 0.02], np.float32)
    if c["n"] == 3:
        d3, i3 = _third_frame()
        depths, images = np.concatenate([depths, d3[None]]), np.concatenate([images, i3[None]])
        init[2] = 0.5 * TRUE_POSE
    kw = dict(poses_init=init, vbf=FX * 5, crw=10.0 if c["photo"] else 0.0, stride=c["n"],
              optimize_7dof=c["dof7"], images=images if c["photo"] else None,
              connectivity=np.asarray(c["conn"]) if "conn" in c else None)
    seen = {}
    real = japi.lm_solve

    def spy(*a, **k):
        seen["res"] = real(*a, **k)
        return seen["res"]

    real_t = tapi.solve_lanes

    def spy_t(*a, **k):
        seen["port"] = real_t(*a, **k)
        return seen["port"]

    monkeypatch.setattr(japi, "lm_solve", spy)
    monkeypatch.setattr(tapi, "solve_lanes", spy_t)
    rj = japi.falign(depths, FX, FY, CX, CY, **kw)
    rt = tapi.falign(depths, FX, FY, CX, CY, device="cpu", **kw)
    assert int(seen["port"][2][0][0]) == int(seen["res"].iters)
    tol = 1e-3 if c["dof7"] else 1e-5
    for a, b in zip(_rel(rt["poses_ret"]), _rel(rj["poses_ret"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    sj, st = rj["scaling_factor"], rt["scaling_factor"]
    np.testing.assert_allclose(st[1:] / st[0], sj[1:] / sj[0], rtol=1e-4)
    for k in ("visibility_mat", "consistency_mat"):
        np.testing.assert_array_equal(np.isnan(rt[k]), np.isnan(rj[k]))
        np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=1e-4)
    assert rt["poses_covar"].shape == rj["poses_covar"].shape
    assert np.isfinite(rt["poses_covar"]).all()


def _pairs_batch():
    """Three lanes of the wedge scene: the pair at two inits, and a lane
    whose ref frame has zero weights (rank-deficient: its covariance fails
    and comes back zero, which the SLAM layer's covar_rank gate rejects)."""
    depths, images = _make_pair(TRUE_POSE)
    shift = np.array([0.02, -0.01, 0.015, 0.1, -0.08, 0.12], np.float32)
    d2, i2 = _make_pair(TRUE_POSE + shift)
    D = np.stack([depths, d2, depths])
    I = np.stack([images, i2, images])
    Wt = np.ones_like(D)
    Wt[2, 0] = 0.0
    init = np.zeros((3, 2, 6), np.float32)
    init[0, 1] = TRUE_POSE + np.array([0.004, -0.003, 0.002, 0.03, -0.02, 0.02], np.float32)
    init[1, 1] = TRUE_POSE + shift
    init[2, 1] = TRUE_POSE
    return D, I, Wt, init


@pytest.mark.parametrize("c2f", [False, True])
def test_falign_pairs_matches_jax(c2f):
    D, I, Wt, init = _pairs_batch()
    kw = dict(weights=Wt, images=I, poses_init=init, vbf=FX * 5, crw=10.0, optimize_7dof=False,
              stride=2)
    if c2f:
        kw.update(coarse_stride=4, fine_iters=12)
    rj = japi.falign_pairs(D, FX, FY, CX, CY, **kw)
    rt = tapi.falign_pairs(D, FX, FY, CX, CY, device="cpu", **kw)
    for i, (a, b) in enumerate(zip(rt, rj)):
        assert (a["iters"], a["iters_coarse"]) == (b["iters"], b["iters_coarse"]), i
        np.testing.assert_allclose(_rel(a["poses_ret"])[0], _rel(b["poses_ret"])[0], rtol=0,
                                   atol=1e-5, err_msg=str(i))
        for k in ("visibility_mat", "consistency_mat"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-4, err_msg=f"{i} {k}")
        ranks = np.linalg.matrix_rank(a["poses_covar"].astype(np.float64))
        ranks_j = np.linalg.matrix_rank(b["poses_covar"].astype(np.float64))
        np.testing.assert_array_equal(ranks, ranks_j)
    assert not np.any(rt[2]["poses_covar"][0]) and np.all(rt[0]["poses_covar"][0].diagonal() > 0)


def test_falign_pairs_lanes_do_not_depend_on_grouping():
    """Per-pair results are the same however the pairs are batched."""
    D, I, Wt, init = _pairs_batch()
    kw = dict(vbf=FX * 5, crw=10.0, optimize_7dof=True, stride=2, coarse_stride=4,
              fine_iters=12, device="cpu")
    together = tapi.falign_pairs(D, FX, FY, CX, CY, weights=Wt, images=I, poses_init=init, **kw)
    for i in range(3):
        alone = tapi.falign_pairs(D[i:i + 1], FX, FY, CX, CY, weights=Wt[i:i + 1],
                                  images=I[i:i + 1], poses_init=init[i:i + 1], **kw)[0]
        assert (alone["iters"], alone["iters_coarse"]) == (together[i]["iters"],
                                                           together[i]["iters_coarse"])
        for k in ("poses_ret", "scaling_factor", "visibility_mat", "consistency_mat"):
            np.testing.assert_allclose(alone[k], together[i][k], rtol=0, atol=1e-6)


def test_covariances_match_jax_at_the_same_params(wedge):
    """pair_covariances at one set of parameters: per-frame inv(JtJ) blocks
    within 2e-3 relative, and a frame without weights fails on both sides."""
    dim_mask = tapi._dim_mask(2, True, True)
    h, w = wedge["depths"].shape[1:]
    jm = wedge["jm"]
    for zero_first in (False, True):
        if zero_first:
            wz = np.asarray(jm.weights).copy()
            wz[0] = 0.0
            jm = jres.FrameMaps(packed=jm.packed, weights=jnp.asarray(wz))
        cj, okj = jsol._pair_covariances(
            jnp.asarray(wedge["params"]), jnp.asarray(PAIRS2), jm, _jintr(), jnp.float32(FX * 5),
            jnp.float32(10.0), True, 2, (h, w), jnp.asarray(dim_mask), 2)
        tm = tres.FrameMaps(packed=wedge["tm"].packed, weights=torch.as_tensor(np.asarray(jm.weights)))
        ct, okt = tsol.pair_covariances(_tprob(tm, True, dim_mask), _t(wedge["params"])[None],
                                        torch.zeros(1, dtype=torch.int64), 2)
        np.testing.assert_array_equal(okt[0].numpy(), np.asarray(okj))
        cj, ct = np.asarray(cj), ct[0].numpy()
        assert okj[1] and not (zero_first and okj[0])
        np.testing.assert_allclose(ct, cj, rtol=2e-3, atol=2e-3 * np.abs(cj).max())


def test_device_none_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    depths, _ = _make_pair(TRUE_POSE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.falign(depths, FX, FY, CX, CY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.falign_pairs(depths[None], FX, FY, CX, CY)
    import voldor_tpu_torch

    with pytest.raises(RuntimeError, match="no CUDA device"):
        voldor_tpu_torch.falign(depths, FX, FY, CX, CY)
