"""The fb_smooth kernel's module (voldor_tpu_torch/ops/fb_smooth.py) and the
engine's fb_smooth_masked against the JAX package, on the CPU.

On CPU tensors ``fb_smooth`` runs its plain version, ``fb_smooth_reference``;
both are held against ``voldor_tpu/ops/fb_smooth.py:fb_smooth`` (a lax.scan)
at several stack shapes, odd sizes and 1-wide lines included. The kernel's
chunked arithmetic in plain torch (``fb_smooth_chunked_reference``) is held
against the same function at 1, 3 and 32 chunks per line (chunks longer
than, shorter than and not dividing the line), and the port's
``fb_smooth_assoc`` against the JAX package's. Inputs are made with numpy
from a seed. Tolerance: rtol = atol = 1e-5 (the recurrence is a stable
probability update: XLA's fused rounding moves the last bits only, and a
chunk's rounded carry-in fades within a few steps). The kernel itself runs
only on a CUDA device (tests marked ``gpu``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voldor_tpu.ops import fb_smooth as jfb
from voldor_tpu.vo.engine import fb_smooth_masked as jfb_masked
from voldor_tpu_torch.ops import fb_smooth as tfb
from voldor_tpu_torch.vo.engine import fb_smooth_masked as tfb_masked

TOL = dict(rtol=1e-5, atol=1e-5)
EMM, NCP = 0.5, 0.9  # the config defaults fb_emm / fb_no_change_prob


def _stack(shape, seed=3):
    rng = np.random.default_rng(seed)
    prob = rng.uniform(0, 1, shape).astype(np.float32)
    m, h, w = shape
    prob[0, h // 4:h // 2 + 1, w // 4:w // 2 + 1] = 0.02  # a low-rigidness block
    return prob


# (3, 29, 40): 40-wide lines do not divide into 32 chunks; (1, 9, 5): lines
# shorter than a chunk
SHAPES = [(1, 9, 13), (3, 7, 11), (5, 12, 17), (2, 9, 1), (1, 1, 21), (3, 29, 40), (1, 9, 5)]
# the kernel's odd shapes: lines shorter than a chunk, or not a multiple of it
GPU_SHAPES = [(m, 37, 61) for m in (1, 2, 3, 5)] + [(2, 1, 61), (2, 37, 1), (1, 1, 1), (3, 185, 613)]


@pytest.mark.parametrize("shape", SHAPES)
def test_fb_smooth_reference_matches_jax(shape):
    prob = _stack(shape)
    j = np.asarray(jfb.fb_smooth(jnp.asarray(prob), EMM, NCP))
    t = tfb.fb_smooth_reference(torch.as_tensor(prob), EMM, NCP)
    assert t.shape == shape and t.dtype == torch.float32 and t.is_contiguous()
    np.testing.assert_allclose(t.numpy(), j, **TOL)


@pytest.mark.parametrize("chunks", [1, 3, 32, None])  # None: the kernel's CHUNKS
@pytest.mark.parametrize("shape", SHAPES)
def test_fb_smooth_chunked_reference_matches_jax(shape, chunks):
    prob = _stack(shape)
    j = np.asarray(jfb.fb_smooth(jnp.asarray(prob), EMM, NCP))
    t = tfb.fb_smooth_chunked_reference(torch.as_tensor(prob), EMM, NCP, chunks)
    assert t.shape == shape and t.dtype == torch.float32 and t.is_contiguous()
    np.testing.assert_allclose(t.numpy(), j, **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_fb_smooth_assoc_matches_jax(shape):
    prob = _stack(shape, seed=5)
    j = np.asarray(jfb.fb_smooth_assoc(jnp.asarray(prob), EMM, NCP))
    t = tfb.fb_smooth_assoc(torch.as_tensor(prob), EMM, NCP)
    assert t.shape == shape and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, **TOL)


@pytest.mark.parametrize("active_n", [0, 3, 5])
def test_fb_smooth_masked_matches_jax(active_n):
    """Only the first active_n maps are smoothed; the rest stay as they are."""
    rig = _stack((5, 11, 15), seed=8)
    j = np.asarray(jfb_masked(jnp.asarray(rig), jnp.int32(active_n), np.float32(EMM), np.float32(NCP)))
    t = tfb_masked(torch.as_tensor(rig), active_n, EMM, NCP).numpy()
    np.testing.assert_allclose(t, j, **TOL)
    np.testing.assert_array_equal(t[active_n:], rig[active_n:])


@pytest.mark.parametrize("active_n", [1, 3, 5])
def test_fb_smooth_masked_writes_into_its_result(active_n, monkeypatch):
    """fb_smooth_masked hands the kernel wrapper the first active_n planes of
    its result as out=; the inactive maps stay bitwise as they were."""
    from voldor_tpu_torch.vo import engine

    rig = torch.as_tensor(_stack((5, 11, 15), seed=9))
    before = rig.clone()
    seen = []
    real = engine.fb_smooth

    def spy(prob, emm, ncp, out=None):
        seen.append(out)
        return real(prob, emm, ncp, out=out)

    monkeypatch.setattr(engine, "fb_smooth", spy)
    got = engine.fb_smooth_masked(rig, active_n, EMM, NCP)
    assert len(seen) == 1 and seen[0] is not None
    assert seen[0].data_ptr() == got.data_ptr() and seen[0].shape[0] == active_n
    assert torch.equal(rig, before)
    assert torch.equal(got[active_n:], rig[active_n:])
    assert torch.equal(got[:active_n], tfb.fb_smooth_reference(rig[:active_n], EMM, NCP))


def test_fb_smooth_wrapper_takes_plain_version_on_cpu():
    """The wrapper picks the plain version by device alone: CPU tensors never
    touch the kernel or its counter; other devices raise."""
    prob = torch.as_tensor(_stack((3, 8, 10)))
    before = tfb.fb_smooth_kernel_launches
    a = tfb.fb_smooth(prob, EMM, NCP)
    b = tfb.fb_smooth_reference(prob, EMM, NCP)
    assert tfb.fb_smooth_kernel_launches == before
    assert torch.equal(a, b)
    out = torch.full_like(prob, -1.0)
    assert tfb.fb_smooth(prob, EMM, NCP, out=out) is out and torch.equal(out, b)
    with pytest.raises(ValueError):
        tfb.fb_smooth(torch.zeros((3, 8, 10), device="meta"), EMM, NCP)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_fb_smooth_kernel_matches_plain_on_gpu(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fb_smooth kernel has no CPU mode")
    prob = torch.as_tensor(_stack(shape), device="cuda")
    before = tfb.fb_smooth_kernel_launches
    got = tfb.fb_smooth(prob, EMM, NCP)
    assert tfb.fb_smooth_kernel_launches == before + 1
    ref = tfb.fb_smooth_reference(prob, EMM, NCP)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), **TOL)
    chunked = tfb.fb_smooth_chunked_reference(prob, EMM, NCP)
    np.testing.assert_allclose(got.cpu().numpy(), chunked.cpu().numpy(), **TOL)
    out = torch.empty_like(prob)
    assert tfb.fb_smooth(prob, EMM, NCP, out=out) is out and torch.equal(out, got)
