"""The port's host utilities against the JAX package's: the KITTI relative
errors and pose-file reader (voldor_tpu_torch/utils/evaluation.py, within
1e-12 of voldor_tpu/utils/evaluation.py: both are the same float64 numpy
arithmetic), the Chrome-trace exporter with the tracer's ranges, the
provenance stamp and the GL viewer's gate, as tests/test_aux.py and
tests/test_evaluation.py hold the JAX package's.
"""

import numpy as np
import pytest

from voldor_tpu_torch.utils import evaluation as tev
from voldor_tpu_torch.utils import profiling
from voldor_tpu_torch.utils.artifacts import git_rev, stamp
from voldor_tpu_torch.utils.profiling import device_trace


def _trajectory(seed, n=400, step=2.5, noise=0.0):
    """A seeded drive: (n, 4, 4) cam -> world poses, ~step metres apart,
    slowly turning; `noise` perturbs positions and headings."""
    rng = np.random.default_rng(seed)
    yaw = np.cumsum(rng.normal(0, 0.01, n))
    pos = np.cumsum(np.stack([np.sin(yaw), 0.01 * rng.normal(size=n), np.cos(yaw)], 1) * step, 0)
    T = np.tile(np.eye(4), (n, 1, 1))
    yaw = yaw + noise * rng.normal(size=n)
    c, s = np.cos(yaw), np.sin(yaw)
    T[:, 0, 0], T[:, 0, 2], T[:, 2, 0], T[:, 2, 2] = c, s, -s, c
    T[:, :3, 3] = pos + noise * rng.normal(size=(n, 3))
    return T


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kitti_rel_errors_match_jax(seed):
    from voldor_tpu.utils import evaluation as jev

    gt = _trajectory(seed)
    est = _trajectory(seed + 10, noise=0.02) @ np.linalg.inv(_trajectory(seed + 10)) @ gt
    t, r = tev.kitti_rel_errors(est, gt)
    tj, rj = jev.kitti_rel_errors(est, gt)
    assert np.isfinite(t) and np.isfinite(r) and t > 0
    np.testing.assert_allclose([t, r], [tj, rj], rtol=0, atol=1e-12)
    np.testing.assert_allclose(tev._trajectory_distances(gt), jev._trajectory_distances(gt),
                               rtol=0, atol=1e-12)
    # shorter than the smallest length: NaNs, as the JAX package returns
    short = tev.kitti_rel_errors(est[:10], gt[:10])
    assert all(np.isnan(v) for v in short)
    assert tev.kitti_rel_errors(est, gt, lengths=(50,), step=5) == pytest.approx(
        jev.kitti_rel_errors(est, gt, lengths=(50,), step=5), abs=1e-12)


def test_load_kitti_poses_matches_jax(tmp_path):
    from voldor_tpu.utils import evaluation as jev

    T = _trajectory(3, n=20, noise=0.01)
    path = tmp_path / "poses.txt"
    np.savetxt(path, T[:, :3, :4].reshape(-1, 12))
    got = tev.load_kitti_poses(str(path))
    assert got.shape == (20, 4, 4)
    np.testing.assert_allclose(got, jev.load_kitti_poses(str(path)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, T, rtol=0, atol=1e-12)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import json

    import torch

    with device_trace(str(tmp_path)) as prof:
        torch.ones(8).sum()
        profiling.open_record("vo.call")
        with profiling.span("engine.solve"):
            torch.ones(8).sum()
        profiling.close_record()
    assert prof.key_averages() is not None
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"voldor::vo.call", "voldor::engine.solve"} <= names


def test_stamp_prepends_provenance():
    rec = stamp({"fps": 1.5}, backend="gpu")
    assert list(rec) == ["measured_at", "fps"] and rec["fps"] == 1.5
    meta = rec["measured_at"]
    assert meta["git_rev"] == git_rev() and meta["backend"] == "gpu"
    assert len(meta["utc"]) == 20 and meta["utc"].endswith("Z")
    assert git_rev("/") == "unknown"


def test_gl_viewer_headless_gating(monkeypatch):
    """GLViewer gates on DISPLAY (and PyOpenGL), as the JAX package's."""
    from voldor_tpu_torch.slam.gl_viewer import GLViewer

    from voldor_tpu.slam.gl_viewer import GLViewer as JaxGLViewer

    monkeypatch.delenv("DISPLAY", raising=False)
    assert GLViewer.available() is False
    assert JaxGLViewer.available() is False
