"""The pose sweep's three kernels (``csrc/p4p_kernel.cu``,
``csrc/meanshift_kernel.cu``, ``csrc/robust_gaussian_kernel.cu``): their
plain versions against the JAX package on the CPU, at the edge cases the
kernels must reproduce; the wrappers' packing of their arguments; the
fixed-order pool sum; and, marked gpu (skipped without a CUDA device), each
kernel against its plain version on the card.

The inputs are made with numpy from seeds and handed to both packages; the
random draws (4-subsets, meanshift init trials) are taken from the JAX
side's own ``jax.random`` calls and fed to the port. The JAX side runs op
by op (``jax.disable_jit``). Tolerances are stated per test.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from voldor_tpu.ops import lie as jlie
from voldor_tpu.ops import meanshift as jms
from voldor_tpu.ops import p3p as jp3p
from voldor_tpu.ops import robust_gaussian as jrg
from voldor_tpu_torch.ops import meanshift as tms
from voldor_tpu_torch.ops import p3p as tp3p
from voldor_tpu_torch.ops import reduce as tred
from voldor_tpu_torch.ops import robust_gaussian as trg

FX, FY, CX, CY = 500.0, 480.0, 320.0, 240.0


def _t(a):
    return torch.as_tensor(np.array(a))


def _same(a, b):
    """Bitwise equal, NaN where the other is NaN (a refused hypothesis's
    rvec may be NaN)."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


# --------------------------------------------------------------------------
# the fixed-order pool sum
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 5, 8, 13, 64, 100])
def test_block_sum_order(n):
    """block_sum adds rows strided over the lanes, then a halving tree:
    bitwise the same as that order written as a float32 loop."""
    threads = 8
    x = np.random.default_rng(n).normal(size=(3, n)).astype(np.float32) * 1e3
    got = tred.block_sum(_t(x), threads).numpy()
    for r in range(3):
        lanes = [np.float32(0.0)] * threads
        for t in range(threads):
            rows = range(t, n, threads)
            acc = np.float32(0.0)
            for k, p in enumerate(rows):
                acc = x[r, p] if k == 0 else np.float32(acc + x[r, p])
            lanes[t] = acc
        w = threads
        while w > 1:
            w //= 2
            lanes = [np.float32(lanes[i] + lanes[i + w]) for i in range(w)]
        assert got[r] == lanes[0]


def test_block_sum_is_the_kernels_width():
    assert tred.THREADS == 512
    src = (tred.__file__.rsplit("/", 2)[0] + "/csrc/pose_reduce.cuh")
    assert "constexpr int kThreads = 512;" in open(src).read()


# --------------------------------------------------------------------------
# P4P
# --------------------------------------------------------------------------


def _scene(seed=3):
    """30 points in front of a camera at a known pose, their pixels, and
    extra rows: the midpoint of rows 0 and 1 (collinear with them), a point
    behind the camera, a NaN pixel and a NaN point."""
    rng = np.random.default_rng(seed)
    rvec = np.array([0.05, -0.08, 0.03], np.float32)
    t = np.array([0.3, -0.1, 0.5], np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rvec)), np.float64)
    pc = np.stack([rng.uniform(-2, 2, 30), rng.uniform(-1.5, 1.5, 30), rng.uniform(4, 9, 30)], 1)
    pw = (pc - t) @ R  # p_cam = R p_w + t
    mid = 0.5 * (pw[0] + pw[1])
    behind_c = np.array([0.5, 0.2, -3.0])
    pw = np.concatenate([pw, mid[None], ((behind_c - t) @ R)[None], pw[2:3], pw[3:4]])
    pc = pw @ R.T + t
    px = np.stack([CX + FX * pc[:, 0] / pc[:, 2], CY + FY * pc[:, 1] / pc[:, 2]], 1)
    px[32] = np.nan  # a NaN pixel (row 32, a copy of point 2)
    pw[33] = np.nan  # a NaN point (row 33, a copy of point 3)
    return px.astype(np.float32), pw.astype(np.float32), rvec, t


EDGE_SUBSETS = {
    "collinear": (0, 1, 30, 5),  # row 30 is the midpoint of rows 0 and 1
    "coincident": (4, 4, 6, 7),
    "behind_camera": (31, 8, 9, 10),
    "behind_camera_4th": (8, 9, 10, 31),
    "nan_pixel": (32, 11, 12, 13),
    "nan_point": (14, 33, 15, 16),
    "tie_4th_is_1st": (17, 18, 19, 17),  # every depth triple reprojects the 4th alike
    "tie_4th_is_2nd": (20, 21, 22, 21),
}


def _jax_p4p(P2, P3):
    with jax.disable_jit():
        out = jax.vmap(jp3p._p4p_single, in_axes=(0, 0, None, None, None, None))(
            jnp.asarray(P2), jnp.asarray(P3), FX, FY, CX, CY)
    return tuple(np.asarray(a) for a in out)


def test_p4p_edge_subsets_match_jax():
    """Random 4-subsets and the edge subsets (collinear, coincident, a
    point behind the camera, NaN rows, a 4th point that ties the depth
    triples) solved by both packages: the same ok flags, and where ok rvec
    and t within atol 1e-5 (measured: 9.5e-7 at most, 1.5e-7 the median;
    both packages take the same float32 expression order, XLA's CPU dots
    fuse their multiply-adds and PyTorch's products do not)."""
    px, pw, rvec, tvec = _scene()
    rng = np.random.default_rng(11)
    subs = [tuple(rng.choice(30, 4, replace=False)) for _ in range(40)] + list(EDGE_SUBSETS.values())
    sel = np.asarray(subs)
    P2, P3 = px[sel], pw[sel]
    rv, tv, ok = _jax_p4p(P2, P3)
    trv, ttv, tok = (a.numpy() for a in tp3p._p4p_batch(_t(P2), _t(P3), FX, FY, CX, CY))
    np.testing.assert_array_equal(tok, ok)
    names = list(EDGE_SUBSETS)
    edge_ok = dict(zip(names, ok[40:]))
    assert not edge_ok["nan_pixel"] and not edge_ok["nan_point"]
    assert ok[:40].mean() > 0.9
    both = ok & tok
    err = np.maximum(np.abs(trv - rv).max(axis=1), np.abs(ttv - tv).max(axis=1))[both]
    assert err.max() <= 1e-5, err.max()
    # exact correspondences: the random subsets recover the true pose
    assert np.median(np.abs(trv[:40][tok[:40]] - rvec).max(axis=1)) < 1e-4


@pytest.mark.parametrize("n_valid", [0, 3, 4])
def test_p4p_fewer_than_four_valid(n_valid):
    """Below 4 valid correspondences every hypothesis is refused (the
    draws then index the first rows of the compaction, as in JAX). At 4,
    the draws repeat rows: the same ok flags as JAX, and where ok the same
    rvec and t within atol 1e-5, except where the 4th row repeats one of
    the first three. That 4th point ties the depth triples' reprojection
    errors, the last bit of each picks the winner, and the two packages
    may pick different triples: there the port's pose must reproject the
    first three points within 1e-2 px."""
    px, pw, _, _ = _scene()
    valid = np.zeros(30, bool)
    valid[[5, 9, 17, 23][:n_valid]] = True
    key = jax.random.PRNGKey(2)
    idx = np.asarray(jax.random.randint(key, (16, 4), 0, max(n_valid, 1)))
    with jax.disable_jit():
        rv, tv, ok = (np.asarray(a) for a in jp3p.solve_batch_p4p(
            jnp.asarray(px[:30]), jnp.asarray(pw[:30]), jnp.asarray(valid), key, FX, FY, CX, CY,
            n_poses=16))
    trv, ttv, tok = (a.numpy() for a in tp3p.solve_batch_p4p(
        _t(px[:30]), _t(pw[:30]), _t(valid), _t(idx), FX, FY, CX, CY))
    np.testing.assert_array_equal(tok, ok)
    assert ok.any() == (n_valid >= 4)
    tie = (idx[:, 3:] == idx[:, :3]).any(axis=1)
    np.testing.assert_allclose(trv[ok & ~tie], rv[ok & ~tie], atol=1e-5)
    np.testing.assert_allclose(ttv[ok & ~tie], tv[ok & ~tie], atol=1e-5)
    rows = np.flatnonzero(valid)[idx[ok & tie, :3]]  # (n, 3) source rows
    R = np.asarray(jlie.so3_exp(jnp.asarray(trv[ok & tie])))
    pc = np.einsum("nij,nkj->nki", R, pw[rows]) + ttv[ok & tie][:, None]
    uv = np.stack([CX + FX * pc[..., 0] / pc[..., 2], CY + FY * pc[..., 1] / pc[..., 2]], -1)
    assert np.abs(uv - px[rows]).max(initial=0.0) < 1e-2


def test_p4p_pool_packing():
    """solve_batch_p4p_pool on the CPU: leading dims kept, the pool row
    [rvec * scale, t] float32 and its validity 0 / 1 float32, equal to
    solve_batch_p4p's outputs."""
    px, pw, _, _ = _scene()
    valid = np.ones((2, 30), bool)
    valid[1, ::3] = False
    p2 = np.stack([px[:30], px[:30]])
    p3 = np.stack([pw[:30], pw[:30]])
    idx = np.random.default_rng(5).integers(0, 20, (2, 24, 4))
    args = (_t(p2), _t(p3), _t(valid), _t(idx), FX, FY, CX, CY)
    rv, tv, ok = tp3p.solve_batch_p4p(*args)
    pool, pool_valid = tp3p.solve_batch_p4p_pool(*args, 25.0)
    assert pool.shape == (2, 24, 6) and pool.dtype == torch.float32
    assert pool_valid.shape == (2, 24) and pool_valid.dtype == torch.float32
    assert _same(pool, torch.cat([rv * 25.0, tv], dim=-1))
    assert torch.equal(pool_valid, ok.to(torch.float32))
    assert ok.dtype == torch.bool and rv.shape == (2, 24, 3)


# --------------------------------------------------------------------------
# meanshift
# --------------------------------------------------------------------------


def _trials(key, valid, T):
    """The JAX meanshift's init-trial draws (one split per trial)."""
    k, out = key, []
    with jax.disable_jit():
        for _ in range(T):
            k, sub = jax.random.split(k)
            out.append(int(jax.random.choice(sub, valid.shape[0], p=jnp.asarray(valid) / valid.sum())))
    return np.asarray(out)


def _pool(seed, P=256, D=6, inlier_frac=0.6):
    rng = np.random.default_rng(seed)
    n_in = int(P * inlier_frac)
    centre = rng.normal(0, 1, D)
    inl = centre + rng.normal(0, 0.05, (n_in, D))
    out = rng.uniform(-3, 3, (P - n_in, D))
    space = np.concatenate([inl, out]).astype(np.float32)
    valid = (rng.uniform(size=P) > 0.1).astype(np.float32)
    return space, valid, centre.astype(np.float32), n_in


def _ms_both(space, valid, init, ext, key, T=20, kernel_var=0.1, max_iters=100, epsilon=1e-5):
    trials = _trials(key, valid, T)
    with jax.disable_jit():
        j = jms.meanshift(jnp.asarray(space), jnp.asarray(valid), kernel_var, jnp.asarray(init),
                          jnp.bool_(ext), key, max_iters=max_iters, max_init_trials=T,
                          epsilon=epsilon)
    t = tms.meanshift(_t(space)[None], _t(valid)[None], kernel_var, _t(init)[None],
                      torch.tensor([ext]), _t(trials)[None], max_iters=max_iters, epsilon=epsilon)
    return j, t, trials


def _ms_agree(j, t, tol=1e-5):
    """Mean and confidence rtol = atol = 1e-5, the same iterations and count."""
    np.testing.assert_allclose(t.mean[0].numpy(), np.asarray(j.mean), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(t.confidence[0]), float(j.confidence), rtol=tol, atol=tol)
    assert int(t.iters[0]) == int(j.iters)
    assert int(t.n_valid[0]) == int(j.n_valid)


@pytest.mark.parametrize("external_init", [False, True])
def test_meanshift_external_init_matches_jax(external_init):
    space, valid, centre, _ = _pool(1)
    init = centre + 0.08
    j, t, _ = _ms_both(space, valid, init, external_init, jax.random.PRNGKey(3))
    _ms_agree(j, t)
    assert 1 < int(j.iters) < 100


def _key_where(valid, T, inl, want, tries=200):
    """The first key whose trials hit the inliers first at trial `want`."""
    for s in range(tries):
        key = jax.random.PRNGKey(s)
        hits = np.flatnonzero(_trials(key, valid, T) < inl)
        if len(hits) and hits[0] == want:
            return key
    raise AssertionError("no key found")


@pytest.mark.parametrize("where", ["first", "last"])
def test_meanshift_trial_early_stop_matches_jax(where):
    """The init trials' early stop replayed: a pool whose dense mode holds
    over half the valid rows stops at the first trial that lands in it,
    the first trial here, or the last of T = 3 (the earlier trials landed
    among the outliers)."""
    T = 3
    frac = 0.9 if where == "first" else 0.55
    space, valid, _, n_in = _pool(2, inlier_frac=frac)
    key = _key_where(valid, T, n_in, 0 if where == "first" else T - 1)
    j, t, trials = _ms_both(space, valid, np.zeros(6, np.float32), False, key, T=T)
    assert (trials[:-1] >= n_in).all() if where == "last" else trials[0] < n_in
    _ms_agree(j, t)


def test_meanshift_max_iters_matches_jax():
    """epsilon 0: every search runs to max_iters."""
    space, valid, centre, _ = _pool(4)
    j, t, _ = _ms_both(space, valid, centre + 0.3, True, jax.random.PRNGKey(5), max_iters=3,
                       epsilon=0.0)
    _ms_agree(j, t)
    assert int(t.iters[0]) == 3


def test_meanshift_all_invalid_matches_jax():
    """No valid row: every weight is 0, wsum clamps to 1e-30, one step."""
    space, _, _, _ = _pool(6)
    valid = np.zeros(space.shape[0], np.float32)
    j, t, _ = _ms_both(space, valid, np.ones(6, np.float32), False, jax.random.PRNGKey(7))
    _ms_agree(j, t)
    assert int(t.iters[0]) == 1 and int(t.n_valid[0]) == 0


def test_meanshift_ground_pool_matches_jax():
    """The KITTI ground fit's 4-D pool (vo/kitti_ground.py): (height /
    median, normal), the external start (1, 0, -1, 0), kernel variance
    0.01, one dummy trial."""
    rng = np.random.default_rng(9)
    n = rng.normal([0, -1, 0], 0.02, (300, 3))
    h = rng.normal(1.0, 0.03, (300, 1))
    space = np.concatenate([np.concatenate([h, n], 1), rng.uniform(-2, 2, (100, 4))]).astype(np.float32)
    valid = np.ones(400, np.float32)
    valid[::17] = 0
    init = np.array([1.0, 0.0, -1.0, 0.0], np.float32)
    with jax.disable_jit():
        j = jms.meanshift(jnp.asarray(space), jnp.asarray(valid), 0.01, jnp.asarray(init),
                          jnp.bool_(True), jax.random.PRNGKey(0), max_init_trials=1)
    t = tms.meanshift(_t(space)[None], _t(valid)[None], 0.01, _t(init)[None],
                      torch.tensor([True]), torch.zeros((1, 1), dtype=torch.long))
    _ms_agree(j, t)
    assert int(j.iters) > 1


def test_meanshift_packing():
    """Leading dims (2, 3): the same results as each search alone; dtypes."""
    sp, va, ex, tr, ini = [], [], [], [], []
    for s in range(6):
        space, valid, centre, _ = _pool(20 + s, P=128)
        sp.append(space), va.append(valid), ex.append(s % 2 == 0), ini.append(centre + 0.05)
        tr.append(np.random.default_rng(s).integers(0, 128, 7))
    shape = (2, 3)
    res = tms.meanshift(_t(np.stack(sp)).reshape(shape + (128, 6)), _t(np.stack(va)).reshape(shape + (128,)),
                        0.1, _t(np.stack(ini)).reshape(shape + (6,)), _t(np.asarray(ex)).reshape(shape),
                        _t(np.stack(tr)).reshape(shape + (7,)))
    assert res.mean.shape == (2, 3, 6) and res.iters.dtype == torch.int32
    assert res.n_valid.dtype == torch.int32 and res.confidence.shape == (2, 3)
    for s in range(6):
        one = tms.meanshift(_t(sp[s])[None], _t(va[s])[None], 0.1, _t(ini[s])[None],
                            torch.tensor([ex[s]]), _t(tr[s])[None])
        i, k = divmod(s, 3)
        assert torch.equal(res.mean[i, k], one.mean[0]) and torch.equal(res.iters[i, k], one.iters[0])


# --------------------------------------------------------------------------
# the robust-Gaussian refit
# --------------------------------------------------------------------------


def _rg_pool(seed, P=400):
    rng = np.random.default_rng(seed)
    s = 100.0
    inl = rng.multivariate_normal(np.zeros(6), np.diag([0.04, 0.02, 0.03, 1e-3, 2e-3, 1e-3]), P * 3 // 4)
    outl = rng.uniform(-3.0, 3.0, (P - P * 3 // 4, 6))
    space = (np.concatenate([inl, outl]) * s).astype(np.float32)
    valid = (rng.uniform(size=P) > 0.05).astype(np.float32)
    return space, valid


def _rg_both(space, valid, mean0, covar0):
    with jax.disable_jit():
        j = jrg.fit_robust_gaussian(jnp.asarray(space), jnp.asarray(valid), jnp.asarray(mean0),
                                    jnp.asarray(covar0))
    t = trg.fit_robust_gaussian(_t(space)[None], _t(valid)[None], _t(mean0), _t(covar0))
    return j, t


def _rg_agree(j, t):
    """Mean rtol 1e-5 (atol 1e-4), covariance rtol 1e-4 (atol 1e-4), the
    same density (rtol 1e-6), iterations and reliability."""
    assert bool(j.reliable) == bool(t.reliable[0])
    assert int(t.iters[0]) == int(j.iters)
    np.testing.assert_allclose(t.mean[0].numpy(), np.asarray(j.mean), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(t.covar[0].numpy(), np.asarray(j.covar), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(t.density[0]), float(j.density), rtol=1e-6)


def test_rg_singular_covariance_fails_like_jax():
    """A singular start (rank 5): the Schur inverse's det gate fails at the
    first iteration; the fit is unreliable and returns its start."""
    space, valid = _rg_pool(1)
    covar0 = np.eye(6, dtype=np.float32) * 2000.0
    covar0[5, 5] = 0.0
    j, t = _rg_both(space, valid, np.zeros(6, np.float32), covar0)
    _rg_agree(j, t)
    assert not bool(t.reliable[0]) and int(t.iters[0]) == 1
    assert torch.equal(t.covar[0], _t(covar0)) and float(t.density[0]) == 0.0


def test_rg_converges_at_the_first_iteration_like_jax():
    """A start far from every row: no inlier, wsum 0 equals the initial
    previous sum, so the first iteration converges with the start."""
    space, valid = _rg_pool(2)
    mean0 = np.full(6, 1e4, np.float32)
    covar0 = np.eye(6, dtype=np.float32)
    j, t = _rg_both(space, valid, mean0, covar0)
    _rg_agree(j, t)
    assert bool(t.reliable[0]) and int(t.iters[0]) == 1 and float(t.density[0]) == 0.0


def test_rg_all_invalid_like_jax():
    space, _ = _rg_pool(3)
    valid = np.zeros(space.shape[0], np.float32)
    j, t = _rg_both(space, valid, np.zeros(6, np.float32), np.eye(6, dtype=np.float32) * 2000.0)
    _rg_agree(j, t)
    assert int(t.iters[0]) == 1


def test_rg_fit_matches_jax():
    """A mode plus outliers, several EM iterations."""
    space, valid = _rg_pool(4)
    j, t = _rg_both(space, valid, np.full(6, 1.0, np.float32), np.eye(6, dtype=np.float32) * 2000.0)
    _rg_agree(j, t)
    assert bool(t.reliable[0]) and int(t.iters[0]) > 2


def test_rg_packing():
    """mean0 (6,) and covar0 (6, 6) broadcast over a (2,) batch; dtypes."""
    a, va = _rg_pool(5)
    b, vb = _rg_pool(6)
    res = trg.fit_robust_gaussian(_t(np.stack([a, b])), _t(np.stack([va, vb])),
                                  _t(np.zeros(6, np.float32)), _t(np.eye(6, dtype=np.float32) * 2000.0))
    assert res.mean.shape == (2, 6) and res.covar.shape == (2, 6, 6)
    assert res.iters.dtype == torch.int32 and res.reliable.dtype == torch.bool
    one = trg.fit_robust_gaussian(_t(b)[None], _t(vb)[None], _t(np.zeros(6, np.float32)),
                                  _t(np.eye(6, dtype=np.float32) * 2000.0))
    assert torch.equal(res.covar[1], one.covar[0]) and torch.equal(res.iters[1], one.iters[0])


def test_wrappers_refuse_other_devices():
    meta = torch.empty((1, 8, 6), device="meta")
    with pytest.raises(ValueError):
        tms.meanshift(meta, torch.empty((1, 8), device="meta"), 0.1,
                      torch.empty((1, 6), device="meta"), torch.empty(1, dtype=torch.bool, device="meta"),
                      torch.empty((1, 2), dtype=torch.long, device="meta"))
    with pytest.raises(ValueError):
        trg.fit_robust_gaussian(meta, torch.empty((1, 8), device="meta"),
                                torch.empty(6, device="meta"), torch.empty((6, 6), device="meta"))
    with pytest.raises(ValueError):
        tp3p.solve_batch_p4p(torch.empty((8, 2), device="meta"), torch.empty((8, 3), device="meta"),
                             torch.empty(8, dtype=torch.bool, device="meta"),
                             torch.empty((4, 4), dtype=torch.long, device="meta"), FX, FY, CX, CY)


# --------------------------------------------------------------------------
# the kernels (a CUDA device)
# --------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pose kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_p4p_kernel_matches_plain_on_gpu():
    """ok flags equal on >= 99.9% of the hypotheses; where both are ok,
    rvec and t within 1e-4 on >= 99% and 1e-3 on all; two launches
    bitwise equal; one launch counted."""
    dev = _cuda()
    px, pw, _, _ = _scene()
    valid = np.ones(px.shape[0], bool)
    idx = np.random.default_rng(1).integers(0, px.shape[0], (2, 4096, 4))
    args = (_t(np.stack([px, px])).to(dev), _t(np.stack([pw, pw])).to(dev),
            _t(np.stack([valid, valid])).to(dev), _t(idx).to(dev), FX, FY, CX, CY)
    before = tp3p.p4p_kernel_launches
    rv, tv, ok = tp3p.solve_batch_p4p(*args)
    assert tp3p.p4p_kernel_launches == before + 1
    prv, ptv, pok = tp3p.solve_batch_p4p_reference(*args)
    assert (ok == pok).double().mean() >= 0.999
    both = ok & pok
    err = torch.maximum((rv - prv).abs().amax(-1), (tv - ptv).abs().amax(-1))[both]
    assert (err <= 1e-4).double().mean() >= 0.99 and float(err.max()) <= 1e-3
    rv2, tv2, ok2 = tp3p.solve_batch_p4p(*args)
    assert _same(rv, rv2) and _same(tv, tv2) and torch.equal(ok, ok2)


@pytest.mark.gpu
@pytest.mark.parametrize("external_init", [False, True])
def test_meanshift_kernel_matches_plain_on_gpu(external_init):
    dev = _cuda()
    space, valid, centre, _ = _pool(1, P=8192)
    trials = np.random.default_rng(2).integers(0, 8192, (1, 20))
    args = (_t(space)[None].to(dev), _t(valid)[None].to(dev), 0.1, _t(centre + 0.05)[None].to(dev),
            torch.tensor([external_init], device=dev), _t(trials).to(dev))
    k = tms.meanshift(*args)
    p = tms.meanshift_reference(*args)
    assert torch.equal(k.iters, p.iters) and torch.equal(k.n_valid, p.n_valid)
    torch.testing.assert_close(k.mean, p.mean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(k.confidence, p.confidence, rtol=1e-5, atol=1e-5)
    k2 = tms.meanshift(*args)
    assert torch.equal(k.mean, k2.mean) and torch.equal(k.iters, k2.iters)


@pytest.mark.gpu
def test_rg_kernel_matches_plain_on_gpu():
    dev = _cuda()
    space, valid = _rg_pool(4, P=8192)
    args = (_t(space)[None].to(dev), _t(valid)[None].to(dev), _t(np.full(6, 1.0, np.float32)).to(dev),
            _t(np.eye(6, dtype=np.float32) * 2000.0).to(dev))
    k = trg.fit_robust_gaussian(*args)
    p = trg.fit_robust_gaussian_reference(*args)
    assert torch.equal(k.iters, p.iters) and torch.equal(k.reliable, p.reliable)
    torch.testing.assert_close(k.mean, p.mean, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(k.covar, p.covar, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(k.density, p.density, rtol=1e-6, atol=0.0)
    k2 = trg.fit_robust_gaussian(*args)
    assert torch.equal(k.covar, k2.covar) and torch.equal(k.iters, k2.iters)
