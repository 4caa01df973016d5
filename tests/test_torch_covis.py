"""The port's on-device covisibility (voldor_tpu_torch/ops/covis.py) against
the JAX package's (voldor_tpu/ops/covis.py) and against the host gate
(the port's copy of slam_utils.eval_covisibility), on the CPU.

Inputs are those of tests/test_covis.py (72x96, seeds 5 / 9 / 11).
Tolerance: rtol = atol = 1e-5 on every score. On a grid that is not a
multiple of the stride the port follows the JAX version (visibility over
the padded grid size); the host gate divides by the truncated one there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voldor_tpu.ops import covis as jcovis
from voldor_tpu.ops import lie as jlie
from voldor_tpu_torch.ops import covis as tcovis
from voldor_tpu_torch.slam.slam_utils import T6_to_T44, eval_covisibility

TOL = dict(rtol=1e-5, atol=1e-5)


def _K(h, w, f):
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)


def _rand_depth(rng, h, w):
    return (5.0 + 2.0 * rng.random((h, w))).astype(np.float32)


def _chain(T6s):
    T = np.eye(4, dtype=np.float64)
    out = []
    for p in T6s:
        T = T6_to_T44(p).astype(np.float64) @ T
        out.append(T.copy())
    return out


def _window(depth, conf, poses6, n_flows, K, thresh, n_cap=None):
    t = tcovis.covis_window(
        torch.as_tensor(depth), torch.as_tensor(conf), torch.as_tensor(poses6),
        n_flows, torch.as_tensor(K), thresh, n_cap=n_cap,
    ).numpy()
    j = np.asarray(jcovis.covis_window(
        jnp.asarray(depth), jnp.asarray(conf), jnp.asarray(poses6), jnp.int32(n_flows),
        jnp.asarray(K), jnp.float32(thresh), n_cap=n_cap,
    ))
    return t, j


def _keyframe(depth, conf, scale, poses6, n_flows, M, K, thresh):
    t = tcovis.covis_keyframe(
        torch.as_tensor(depth), torch.as_tensor(conf), scale, torch.as_tensor(poses6),
        n_flows, torch.as_tensor(M), torch.as_tensor(K), thresh,
    ).numpy()
    j = np.asarray(jcovis.covis_keyframe(
        jnp.asarray(depth), jnp.asarray(conf), jnp.float32(scale), jnp.asarray(poses6),
        jnp.int32(n_flows), jnp.asarray(M), jnp.asarray(K), jnp.float32(thresh),
    ))
    return t, j


def _window_inputs(h=72, w=96):
    rng = np.random.default_rng(5)
    depth = _rand_depth(rng, h, w)
    conf = rng.random((h, w)).astype(np.float32)
    poses6 = np.zeros((5, 6), np.float32)
    for i in range(5):
        poses6[i, :3] = rng.normal(0, 0.02, 3)
        poses6[i, 3:6] = [0.3, 0.02, 0.2]
    return depth, conf, poses6, _K(h, w, 80.0)


def _keyframe_inputs(h=72, w=96):
    rng = np.random.default_rng(11)
    depth_kf = _rand_depth(rng, h, w)
    conf_kf = rng.random((h, w)).astype(np.float32)
    poses6 = np.zeros((3, 6), np.float32)
    for i in range(3):
        poses6[i, :3] = rng.normal(0, 0.02, 3)
        poses6[i, 3:6] = [0.25, 0.01, 0.15]
    M = np.eye(4, dtype=np.float32)
    M[:3, :3] = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.05, 3).astype(np.float32))))
    M[:3, 3] = [0.4, -0.1, 0.2]
    return depth_kf, conf_kf, 1.37, poses6, M, _K(h, w, 80.0)


def test_covis_window_matches_jax_and_host():
    depth, conf, poses6, K = _window_inputs()
    t, j = _window(depth, conf, poses6, 5, K, 0.5)
    assert t.dtype == np.float32 and t.shape == (5,)
    np.testing.assert_allclose(t, j, **TOL)
    host = [eval_covisibility(depth, T, K, conf > 0.5) for T in _chain(poses6)]
    np.testing.assert_allclose(t, host, **TOL)


def test_covis_window_inactive_frames_repeat():
    """Frames beyond n_flows do not extend the chain: their entries repeat
    the last active score, as in the JAX version."""
    h, w = 48, 64
    rng = np.random.default_rng(9)
    depth = _rand_depth(rng, h, w)
    conf = np.ones((h, w), np.float32)
    poses6 = rng.normal(0, 0.1, (4, 6)).astype(np.float32)
    poses6[:, 3:6] += [0.2, 0, 0.1]
    t, j = _window(depth, conf, poses6, 2, _K(h, w, 60.0), 0.5)
    assert t[2] == t[1] and t[3] == t[1]
    np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("n_flows,n_cap", [(5, 3), (2, 4), (5, None)])
def test_covis_window_n_cap(n_flows, n_cap):
    """n_cap clamps the active chain length (window padding): the scores
    equal those of min(n_flows, n_cap) active frames."""
    depth, conf, poses6, K = _window_inputs()
    t, j = _window(depth, conf, poses6, n_flows, K, 0.5, n_cap=n_cap)
    np.testing.assert_allclose(t, j, **TOL)
    n_act = min(n_flows, n_cap) if n_cap is not None else n_flows
    t_ref, _ = _window(depth, conf, poses6, n_act, K, 0.5)
    np.testing.assert_array_equal(t, t_ref)


def test_covis_keyframe_matches_jax_and_host():
    """spakf gate: covis of the scaled keyframe depth under chain_s @ M."""
    depth_kf, conf_kf, scale, poses6, M, K = _keyframe_inputs()
    t, j = _keyframe(depth_kf, conf_kf, scale, poses6, 3, M, K, 0.5)
    np.testing.assert_allclose(t, j, **TOL)
    host = [eval_covisibility(depth_kf * scale, Tc @ M.astype(np.float64), K, conf_kf > 0.5)
            for Tc in _chain(poses6)]
    np.testing.assert_allclose(t, host, **TOL)


@pytest.mark.parametrize("kind", ["window", "keyframe"])
def test_covis_off_stride_grid_follows_jax(kind):
    """74 x 98 is not a multiple of the stride 4 (nor is the bench's
    185 x 613): the port agrees with the JAX version there, and the JAX
    version's visibility is off the host gate's by the ratio of the grid
    sizes (a known property of the JAX package, which the port keeps)."""
    h, w = 74, 98
    if kind == "window":
        depth, conf, poses6, K = _window_inputs(h, w)
        t, j = _window(depth, conf, poses6, 5, K, 0.5)
        host = [eval_covisibility(depth, T, K, conf > 0.5) for T in _chain(poses6)]
    else:
        depth, conf, scale, poses6, M, K = _keyframe_inputs(h, w)
        t, j = _keyframe(depth, conf, scale, poses6, 3, M, K, 0.5)
        host = [eval_covisibility(depth * scale, Tc @ M.astype(np.float64), K, conf > 0.5)
                for Tc in _chain(poses6)]
    np.testing.assert_allclose(t, j, **TOL)
    assert np.abs(j - np.asarray(host)).max() > 1e-3
