"""The falign LM chunk (ops/falign_kernels.py:lm_chunk): its CPU route, the
plain chunk, against a loop of the port's lm_body and against the JAX
package's LM body run as lm_chunk_pairs' while_loop runs it, per lane; a
chunk of n against n chunks of one, frozen and done lanes included; a
compacted subset of lanes against the full batch. On a CUDA device (tests
marked ``gpu``) the chunk kernel's iterations against the plain step from
the kernel's state, bitwise repeats, no host sync, refusals.

The JAX side runs op by op under ``jax.disable_jit()`` (compiled XLA
contracts multiply-adds into FMAs). Tolerances, those of
tests/test_torch_falign_kernels.py: the parameters within 2e-3 of the
largest parameter move, lam, the cost and w2 within 1e-4 relative, H and g
within 1e-4 of their largest entries, iteration counts and done flags
equal. The CPU route and the plain chunk are the same torch operations as
the loop of lm_body, so those comparisons are bitwise.
"""

import ctypes

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

VBF = FX * 5
CRW = 10.0
STRIDE = 2
PAIRS2 = np.asarray([[0, 1], [1, 0]], np.int32)
BLOCK_RTOL = 1e-4
STEP_RTOL = 2e-3


def _t(a, device="cpu"):
    return torch.as_tensor(np.array(a, np.float32), device=device)


@pytest.fixture(scope="module")
def batch():
    """Three lanes of the wedge scene (two frames each, with images and
    seeded weights): the pair near its true pose, a shifted pair, and the
    first pair from a farther init; seeded scale and colour parameters."""
    rng = np.random.default_rng(31)
    shift = np.array([0.02, -0.01, 0.015, 0.1, -0.08, 0.12], np.float32)
    dA, iA = _make_pair(TRUE_POSE)
    dB, iB = _make_pair(TRUE_POSE + shift)
    depths = np.concatenate([dA, dB, dA])
    images = np.concatenate([iA, iB, iA])
    weights = rng.uniform(0.5, 1.0, depths.shape).astype(np.float32)
    params = np.zeros((3, 2, 9), np.float32)
    params[0, 1, :6] = TRUE_POSE + np.array([0.004, -0.003, 0.002, 0.03, -0.02, 0.02])
    params[1, 1, :6] = TRUE_POSE + shift + np.array([-0.003, 0.002, 0.001, -0.02, 0.03, 0.01])
    params[2, 1, :6] = TRUE_POSE + np.array([0.01, 0.008, -0.006, 0.06, 0.05, -0.04])
    params[:, :, 6:] = rng.normal(0, [0.02, 0.01, 0.5], (3, 2, 3))
    return dict(depths=depths, images=images, weights=weights, params=params)


def _problem(batch, device="cpu"):
    maps = tres.precompute_maps(_t(batch["depths"], device), _t(batch["weights"], device),
                                _t(batch["images"], device), FX, FY, CX, CY)
    gU = np.zeros((1, 18), np.float32)
    gU[0, 6] = gU[0, 15] = 1.0
    prob = tapi._problem(maps, PAIRS2, 2, FX, FY, CX, CY, VBF, CRW, True,
                         tapi._dim_mask(2, True, True), gU, torch.device(device))
    lanes = torch.arange(3, device=device)
    st = tsol.phase_init(prob, _t(batch["params"], device), lanes, STRIDE)
    return prob, lanes, st


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("n", [1, 3, 8])
def test_cpu_route_is_the_loop_of_lm_body(batch, monkeypatch, n):
    """On the CPU, lm_chunk and lm_iterate are n calls of lm_body with the
    chunk's it_end, bitwise."""
    prob, lanes, st = _problem(batch)
    it_end = st.it + n
    loop = st
    for _ in range(n):
        loop = tsol.lm_body(prob, loop, lanes, STRIDE, it_end)
    assert _equal(fk.lm_chunk(prob, st, lanes, STRIDE, n), loop)
    assert _equal(fk.lm_chunk_reference(prob, st, lanes, STRIDE, n), loop)
    calls = []
    real = tsol.lm_body

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tsol, "lm_body", counted)
    assert _equal(tsol.lm_iterate(prob, st, lanes, STRIDE, n), loop) and len(calls) == n
    assert int(loop.it.max()) >= 1


@pytest.mark.parametrize("it_end", [False, True])
def test_chunk_of_n_is_n_chunks_of_one(batch, it_end):
    """A chunk of 5 iterations equals five chunks of one, bitwise: with lane
    1 done and (it_end given) lane 2 out of budget from the start, both
    frozen lanes keep their state."""
    prob, lanes, st = _problem(batch)
    st = st._replace(done=torch.tensor([False, True, False]))
    end = torch.tensor([100, 100, 0], dtype=torch.int32) if it_end else None
    whole = fk.lm_chunk(prob, st, lanes, STRIDE, 5, it_end=end)
    ones = st
    for _ in range(5):
        ones = fk.lm_chunk(prob, ones, lanes, STRIDE, 1, it_end=end)
    assert _equal(whole, ones)
    frozen = [1, 2] if it_end else [1]
    for a, b in zip(whole, st):
        assert torch.equal(a[frozen], b[frozen])
    assert int(whole.it[0]) > 0 and bool(whole.it[2] > 0) != it_end


def test_compacted_lanes_match_the_full_batch(batch):
    """solve_lanes re-runs the live lanes as a compacted batch (their state
    taken at idx, lanes = idx): per lane the same state as the full batch,
    bitwise."""
    prob, lanes, st = _problem(batch)
    full = fk.lm_chunk(prob, st, lanes, STRIDE, 4)
    idx = torch.tensor([2, 0])
    sub = fk.lm_chunk(prob, tsol._take(st, idx), idx, STRIDE, 4)
    assert _equal(sub, tsol._take(full, idx))
    put = tsol._put(st, idx, sub)
    assert all(torch.equal(a[1], b[1]) for a, b in zip(put, st))


def test_chunk_matches_jax_per_lane(batch):
    """Each lane's chunk of 3 iterations against the JAX package's LM body
    (voldor_tpu/falign/solver.py:_make_lm_step) under lm_chunk_pairs'
    while_loop condition (it < it_end and not done), from the same state."""
    prob, lanes, st = _problem(batch)
    n = 3
    out = fk.lm_chunk(prob, st, lanes, STRIDE, n)
    dim_mask = tapi._dim_mask(2, True, True)
    gU = prob.gauge_U.numpy()
    packed = prob.maps.packed.numpy()
    moved = np.abs(out.params.numpy() - batch["params"]).max(axis=(1, 2))
    for l in range(3):
        jm = jres.FrameMaps(packed=jnp.asarray(packed[2 * l:2 * l + 2]),
                            weights=jnp.asarray(batch["weights"][2 * l:2 * l + 2]))
        body, _, _ = jsol._make_lm_step(
            jnp.asarray(PAIRS2), jm, tuple(jnp.float32(v) for v in (FX, FY, CX, CY)),
            jnp.float32(VBF), jnp.float32(CRW), True, STRIDE, (H, W), jnp.asarray(dim_mask),
            jnp.asarray(gU), 2)
        js = (jnp.asarray(st.params[l].numpy()), jnp.float32(float(st.lam[l])),
              jnp.float32(float(st.cost[l])), jnp.asarray(st.H[l].numpy()),
              jnp.asarray(st.g[l].numpy()), jnp.int32(int(st.it[l])),
              jnp.bool_(bool(st.done[l])), jnp.float32(float(st.w2[l])))
        it_end = int(st.it[l]) + n
        with jax.disable_jit():
            while int(js[5]) < it_end and not bool(js[6]):
                js = body(js)
        assert int(out.it[l]) == int(js[5]) and bool(out.done[l]) == bool(js[6]), l
        np.testing.assert_allclose(out.params[l].numpy(), np.asarray(js[0]), rtol=0,
                                   atol=STEP_RTOL * moved[l], err_msg=str(l))
        for a, b in ((out.lam[l], js[1]), (out.cost[l], js[2]), (out.w2[l], js[7])):
            np.testing.assert_allclose(float(a), float(b), rtol=BLOCK_RTOL, err_msg=str(l))
        for a, b in ((out.H[l], js[3]), (out.g[l], js[4])):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=BLOCK_RTOL * np.abs(b).max())
    # lanes 0 and 1 took real steps; lane 2's steps from its far init were all rejected
    assert moved[:2].min() > 1e-3 and moved[2] == 0.0


def test_shared_memory_sizes():
    """The chunk kernel's shared memory per block (csrc/falign_lm.cu): it
    grows with D^2 and not with the pairs; a two-frame lane fits a block of
    an H100 (232,448 bytes) with room to spare, and so does a fully
    connected lane of 26 frames (650 pairs), the largest the damped system
    leaves room for; a 27-frame lane does not (the wrapper refuses it on the
    card)."""
    two = fk.lm_smem_bytes(2, 1, 2)
    lin2 = fk.lin_smem_bytes(2)
    assert lin2 == 4 * (fk.THREADS * 20 + 380 + 2 * fk.N_CONST_WORDS)
    assert two == lin2 + 4 * (10 * 18 + 18 + 1 + 3 * 18 * 18)
    assert two < 64 * 1024
    D = 9 * 26
    big = fk.lm_smem_bytes(26, 1, 26 * 25)
    assert big == 4 * (D * (D + 1) + 2 + 11 * D + 1)
    assert big == fk.lm_smem_bytes(26, 1, 2 * fk.PAIR_GROUP)
    assert big < 232448 - 1024 < 232448 < fk.lm_smem_bytes(27, 1, 27 * 26)
    assert fk.lm_smem_bytes(40, 1, 40 * 39) > 232448


# --------------------------------------------------------------------------
# the kernel (a CUDA device)
# --------------------------------------------------------------------------


def _card(batch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the falign chunk kernel has no CPU mode")
    return _problem(batch, "cuda")


def _step_errs(prob, lanes, st, a, b):
    """One iteration from st by the kernel (a) and by the plain step (b):
    (flags equal, the parameters relative to the plain step's largest move,
    lam and w2 relative, the carried cost, H and g against the plain
    linearisation at the kernel's parameters, relative to their largest
    entries)."""
    flags = (torch.equal(a.it, b.it) and torch.equal(a.done, b.done)
             and torch.equal(a.params != st.params, b.params != st.params))
    move = float((b.params - st.params).abs().max())
    step = float((a.params - b.params).abs().max()) / max(move, 1e-30)
    cost, H_, g_ = fk.assemble(fk._plain_blocks(prob, a.params, lanes, STRIDE), prob.oh_r,
                               prob.oh_t)
    rest = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
               for x, y in ((a.lam, b.lam), (a.w2, b.w2), (a.cost, cost), (a.H, H_), (a.g, g_)))
    return flags, step, rest


@pytest.mark.gpu
def test_chunk_kernel_matches_plain_on_gpu(batch):
    """Two iterations, each by the kernel (a chunk of one) and by the plain
    step from the kernel's state."""
    prob, lanes, st = _card(batch)
    for _ in range(2):
        before = fk.lm_chunk_launches
        kern = fk.lm_chunk(prob, st, lanes, STRIDE, 1)
        assert fk.lm_chunk_launches == before + 1
        plain = fk.lm_step_reference(prob, st, lanes, STRIDE, st.it + 1)
        flags, step, rest = _step_errs(prob, lanes, st, kern, plain)
        assert flags and step < STEP_RTOL and rest < BLOCK_RTOL
        st = kern


@pytest.mark.gpu
def test_chunk_kernel_is_bitwise_reproducible_on_gpu(batch):
    prob, lanes, st = _card(batch)
    st = st._replace(done=torch.tensor([False, True, False], device="cuda"))
    a = fk.lm_chunk(prob, st, lanes, STRIDE, 5)
    assert _equal(a, fk.lm_chunk(prob, st, lanes, STRIDE, 5))
    ones = st
    for _ in range(5):
        ones = fk.lm_chunk(prob, ones, lanes, STRIDE, 1)
    assert _equal(a, ones)
    assert all(torch.equal(x[1], y[1]) for x, y in zip(a, st))


@pytest.mark.gpu
def test_chunk_kernel_makes_no_host_sync_on_gpu(batch):
    prob, lanes, st = _card(batch)
    tsol.lm_iterate(prob, st, lanes, STRIDE, 8)
    torch.cuda.set_sync_debug_mode("error")
    try:
        tsol.lm_iterate(prob, st, lanes, STRIDE, 8)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.gpu
def test_chunk_kernel_refuses_on_gpu(batch):
    prob, lanes, st = _card(batch)
    cpu_maps = tres.FrameMaps(packed=prob.maps.packed.cpu(), weights=prob.maps.weights.cpu())
    with pytest.raises(ValueError, match="expected cuda"):
        fk.lm_chunk(prob._replace(maps=cpu_maps), st, lanes, STRIDE, 1)
    with pytest.raises(TypeError):
        fk.lm_chunk(prob, st._replace(it=st.it.long()), lanes, STRIDE, 1)
    with pytest.raises(RuntimeError, match="shared memory"):
        fk._check_lm_fits(st.params.device, 40, 1, 40 * 39)
    fk._check_lm_fits(st.params.device, 26, 1, 26 * 25)  # the largest lane fits
    # a cluster above the device's 16 blocks is refused by the C entry point
    out = ctypes.c_int(0)
    fn = fk._build.function("falign_lm_max_clusters",
                            [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
    assert fn(2, 1, 2, 32, ctypes.byref(out)) != 0 and out.value == 0
