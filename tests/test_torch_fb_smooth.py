"""The fb_smooth kernel's module (voldor_tpu_torch/ops/fb_smooth.py) and the
engine's fb_smooth_masked against the JAX package, on the CPU.

On CPU tensors ``fb_smooth`` runs its plain version, ``fb_smooth_reference``;
both are held against ``voldor_tpu/ops/fb_smooth.py:fb_smooth`` (a lax.scan)
at several stack shapes, odd sizes and 1-wide lines included. Inputs are
made with numpy from a seed. Tolerance: rtol = atol = 1e-5 (the recurrence
is a stable probability update: XLA's fused rounding moves the last bits
only). The kernel itself runs only on a CUDA device (test marked ``gpu``).
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


@pytest.mark.parametrize("shape", [(1, 9, 13), (3, 7, 11), (5, 12, 17), (2, 9, 1), (1, 1, 21)])
def test_fb_smooth_reference_matches_jax(shape):
    prob = _stack(shape)
    j = np.asarray(jfb.fb_smooth(jnp.asarray(prob), EMM, NCP))
    t = tfb.fb_smooth_reference(torch.as_tensor(prob), EMM, NCP)
    assert t.shape == shape and t.dtype == torch.float32 and t.is_contiguous()
    np.testing.assert_allclose(t.numpy(), j, **TOL)


@pytest.mark.parametrize("active_n", [0, 3, 5])
def test_fb_smooth_masked_matches_jax(active_n):
    """Only the first active_n maps are smoothed; the rest stay as they are."""
    rig = _stack((5, 11, 15), seed=8)
    j = np.asarray(jfb_masked(jnp.asarray(rig), jnp.int32(active_n), np.float32(EMM), np.float32(NCP)))
    t = tfb_masked(torch.as_tensor(rig), active_n, EMM, NCP).numpy()
    np.testing.assert_allclose(t, j, **TOL)
    np.testing.assert_array_equal(t[active_n:], rig[active_n:])


def test_fb_smooth_wrapper_takes_plain_version_on_cpu():
    """The wrapper picks the plain version by device alone: CPU tensors never
    touch the kernel or its counter; other devices raise."""
    prob = torch.as_tensor(_stack((3, 8, 10)))
    before = tfb.fb_smooth_kernel_launches
    a = tfb.fb_smooth(prob, EMM, NCP)
    b = tfb.fb_smooth_reference(prob, EMM, NCP)
    assert tfb.fb_smooth_kernel_launches == before
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tfb.fb_smooth(torch.zeros((3, 8, 10), device="meta"), EMM, NCP)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 3, 5])
def test_fb_smooth_kernel_matches_plain_on_gpu(m):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fb_smooth kernel has no CPU mode")
    prob = torch.as_tensor(_stack((m, 37, 61)), device="cuda")
    before = tfb.fb_smooth_kernel_launches
    got = tfb.fb_smooth(prob, EMM, NCP)
    assert tfb.fb_smooth_kernel_launches == before + 1
    ref = tfb.fb_smooth_reference(prob, EMM, NCP)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), **TOL)
