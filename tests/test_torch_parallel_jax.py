"""The port's multi-device solve (voldor_tpu_torch/parallel) against the JAX
package on the same inputs, on the CPU.

tests/test_torch_parallel.py holds every mesh of the port against the
port's own mesh of one; here (and in tests/test_torch_parallel_round_jax.py,
one depth round on row bands) the mesh of one and the meshes are held
against the JAX package, so an error they would share (a padded row in the
P4P pool, a wrong crop, a wrong start state) shows.

The full solve (``multichip_solve``) runs on tests/test_multichip.py's
window, whole and cut to 30 rows (padded to 32 by both packages): the JAX
package's on one device, the port's on a mesh of one and on sp x hyp =
4 x 2. Their P4P and meanshift draws differ, so both are held to the
rendered poses and to each other.
"""

import numpy as np
import pytest
import torch

from test_torch_parallel import _consistent_window, _poses0, _rel
from voldor_tpu.config import VoldorConfig
from voldor_tpu.parallel import mesh as jmesh
from voldor_tpu_torch.convert import config_from_jax
from voldor_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d, multichip_solve

CPU = "cpu"
N, W = 3, 128

MESHES = {
    "one": lambda: make_mesh(1, devices=[CPU]),
    "sp4": lambda: make_mesh(4, devices=[CPU] * 4),
    "sp4xhyp2": lambda: make_mesh_2d(4, 2, devices=[CPU] * 8),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _cfg(h, max_iters=None):
    cfg = VoldorConfig(fx=40.0, fy=40.0, cx=W / 2, cy=h / 2, basefocal=20.0)
    cfg.n_poses_to_sample = 512
    cfg.depth_rand_samples = 2
    cfg.depth_local_prop_width = 8
    if max_iters is not None:
        cfg.max_iters = max_iters
    return cfg


def _rendered_poses():
    """_consistent_window's relative poses."""
    rng = np.random.default_rng(5)
    poses = np.zeros((N, 6), np.float32)
    for f in range(N):
        poses[f, :3] = rng.normal(0, 0.004, 3)
        poses[f, 3:6] = [0.1, 0.01, 0.3]
    return poses


# --------------------------------------------------------------------------
# the full solve
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[32, 30], ids=["h32", "h30"])
def jax_solve(request):
    """tests/test_multichip.py's full solve on one device of the JAX
    package: 2 EM iterations on the consistent 32 x 128 window, and on its
    first 30 rows, which both packages pad to 32 with inert rows."""
    h = request.param
    flows, depth0 = _consistent_window(N, h, W)
    cfg = _cfg(h, max_iters=2)
    st = jmesh.multichip_solve(jmesh.make_mesh(1), cfg, flows, depth0, _poses0(N))
    return dict(flows=flows, depth0=depth0, cfg=cfg,
                **{k: np.asarray(st[k], np.float64) for k in ("poses6", "depth", "rigidness")})


@pytest.mark.parametrize("mesh", ["one", "sp4xhyp2"])
def test_multichip_solve_matches_jax(jax_solve, mesh):
    """The port's solve against the JAX package's and the rendered poses
    (in the solve's mono gauge). Limits: poses within atol 2e-4 of the
    truth and of the JAX solve (measured at most 3.5e-5 and 3.2e-5; the
    JAX multichip test's KITTI-shape bound is 5e-3); depth and rigidness
    max relative error to the JAX solve < 0.05 (the JAX multichip tests'
    dense bound; measured at most 6.0e-3 and 2.7e-2, as the JAX package's
    own sharded solve is 2e-2 from its single device)."""
    j = jax_solve
    tcfg = config_from_jax(j["cfg"])
    assert tcfg.to_string() == j["cfg"].to_string()
    st = multichip_solve(MESHES[mesh](), tcfg, j["flows"], j["depth0"], _poses0(N))
    truth = _rendered_poses().astype(np.float64)  # in the solve's mono gauge:
    truth[:, 3:] /= np.linalg.norm(truth[:, 3:], axis=1).mean()  # mean |t| = 1
    for poses in (st["poses6"].numpy(), j["poses6"]):
        np.testing.assert_allclose(poses, truth, rtol=0, atol=2e-4)
    np.testing.assert_allclose(st["poses6"].numpy(), j["poses6"], rtol=0, atol=2e-4)
    for k in ("depth", "rigidness"):
        assert st[k].shape == j[k].shape
        assert _rel(st[k].numpy(), j[k]).max() < 0.05, k
