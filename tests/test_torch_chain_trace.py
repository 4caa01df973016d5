"""The chain trace's module (voldor_tpu_torch/ops/chain_trace.py): the
wrapper that ``em.update_rigidness`` and ``em.update_rigidness_and_tracks``
call, its kernel's argument checks, and the benchmark's reader of its
launch count.

On CPU tensors the wrapper composes the plain version, which must be
bitwise equal to ``chain_flow_terms`` -> ``fisk.rigidness_xy`` -> ``where``
(the composition the two em functions ran before the kernel) for both
callers: anchored, with the track planes, and tracked, without. The
kernel's checks run on ``meta`` tensors, which take the kernel's route but
never reach a launch. The kernel itself runs only on a CUDA device (tests
marked ``gpu``): there its track planes and in-bounds mask must be bitwise
equal to the plain version run on the same card, and its rigidness within
``RIG_ATOL`` of it, on a window cut short, points behind the camera,
tracks that leave the image at every edge and NaN coordinates. This file
imports no JAX: ``pytest --noconftest -m gpu`` runs it on a card.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from voldor_tpu_torch.config import VoldorConfig
from voldor_tpu_torch.ops import chain_trace as ct
from voldor_tpu_torch.ops import fisk
from voldor_tpu_torch.ops.lie import so3_exp
from voldor_tpu_torch.vo import em

from synthetic import render_window

ROOT = Path(__file__).resolve().parent.parent
H, W, N = 40, 56, 5
RIG_ATOL = 2e-6  # the kernel's rigidness against the plain version on the card


def _norm(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


@pytest.fixture(scope="module")
def win():
    K = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32)
    planes = [(_norm([0.1, 0.15, 1.0]), 8.0), (_norm([-0.35, 0.1, 1.0]), 6.5),
              (_norm([0.3, -0.25, 1.0]), 7.0)]
    rng = np.random.default_rng(5)
    poses = np.zeros((N, 6), np.float32)
    for f in range(N):
        poses[f, :3] = rng.normal(0, 0.01, 3)
        poses[f, 3:6] = [0.3 + 0.05 * rng.normal(), 0.05 * rng.normal(), 0.25]

    def r2R(rv):
        return so3_exp(torch.as_tensor(np.asarray(rv, np.float32))).numpy()

    flows, depth0, _ = render_window(K, poses, planes, H, W, r2R)
    flows = flows + rng.normal(0, 0.3, flows.shape).astype(np.float32)
    cfg = VoldorConfig(fx=50.0, fy=50.0, cx=W / 2, cy=H / 2, basefocal=20.0)
    p = em.EmParams.from_config(cfg, has_disparity=False)
    return dict(flows=torch.as_tensor(flows), depth=torch.as_tensor(depth0 * 1.02),
                Rs=so3_exp(torch.as_tensor(poses[:, :3])), ts=torch.as_tensor(poses[:, 3:6]), p=p)


def _case(win, name):
    """(depth, flows, Rs, ts, active_n) of one named case."""
    depth, Rs, ts, active_n = win["depth"].clone(), win["Rs"], win["ts"].clone(), N
    if name == "short":  # the window cut short: frames 3 and 4 untraced
        active_n = 3
    elif name == "behind":  # points behind the camera and on its plane
        depth[5:15, 10:30] *= -1.0
        depth[20:24, :] = 0.0
    elif name == "edges":  # towards the scene: tracks leave at every edge
        ts[:, 2] = -3.0
    elif name == "nan":  # +inf depth: NaN positions from frame 1 on; NaN depth
        depth[3:6, 7:40] = torch.inf
        depth[30, 2:9] = torch.nan
    return depth.contiguous(), win["flows"].contiguous(), Rs, ts, active_n


def _plain(depth, flows, Rs, ts, active_n, p):
    """The composition em.update_rigidness(_and_tracks) ran before the kernel."""
    rx, ry, obx, oby, inb, px1, py1 = ct.chain_flow_terms(depth, flows, Rs, ts, active_n, p)
    r = fisk.rigidness_xy(rx, ry, obx, oby, p.lam, p.abs_resize_factor)
    return torch.where(inb, r, 0.0), (px1, py1, obx, oby), inb


def _same(a, b):
    """Bitwise equal as floats, NaN where NaN."""
    return bool(torch.equal(a.isnan(), b.isnan())
                and torch.equal(torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0)))


CASES = ("plain", "short", "behind", "edges", "nan")


@pytest.mark.parametrize("name", CASES)
def test_cpu_wrapper_is_the_plain_composition_bitwise(win, name):
    depth, flows, Rs, ts, active_n = _case(win, name)
    p = win["p"]
    before = ct.chain_trace_launches
    rig, track, inb = em.update_rigidness_and_tracks(depth, flows, Rs, ts, active_n, p)
    rig_t = em.update_rigidness(depth, flows, Rs, ts, active_n, p)
    assert ct.chain_trace_launches == before
    prig, ptrack, pinb = _plain(depth, flows, Rs, ts, active_n, p)
    assert torch.equal(inb, pinb) and inb.dtype == torch.bool
    assert _same(rig, prig) and _same(rig_t, prig)
    for a, b in zip(track, ptrack):
        assert a.shape == (N, H, W) and _same(a, b)
    if active_n < N:
        assert not inb[active_n:].any() and not rig[active_n:].any()
    if name == "edges":
        assert (track[0] < 0).any() and (track[0] >= W).any()
        assert (track[1] < 0).any() and (track[1] >= H).any()
    if name == "nan":
        assert track[0].isnan().any() and rig.isnan().any()


def _meta(n=N, dtype=torch.float32, contiguous=True):
    depth = torch.empty((H, W), dtype=dtype, device="meta")
    flows = torch.empty((n, H, W, 2), dtype=dtype, device="meta")
    if not contiguous:
        flows = torch.empty((n, H, W + 3, 2), dtype=dtype, device="meta")[:, :, :W]
    Rs = torch.empty((n, 3, 3), dtype=dtype, device="meta")
    ts = torch.empty((n, 3), dtype=dtype, device="meta")
    return depth, flows, Rs, ts


@pytest.mark.parametrize("args, exc, match", [
    (dict(n=ct.MAX_N + 1), ValueError, "window frames"),
    (dict(n=0), ValueError, "window frames"),
    (dict(dtype=torch.float64), TypeError, "dtype"),
    (dict(contiguous=False), ValueError, "contiguous"),
    (dict(), ValueError, "unsupported device"),
])
def test_kernel_route_refuses_what_it_cannot_take(win, args, exc, match):
    depth, flows, Rs, ts = _meta(**args)
    before = ct.chain_trace_launches
    with pytest.raises(exc, match=match):
        ct.chain_trace(depth, flows, Rs, ts, 3, win["p"])
    assert ct.chain_trace_launches == before


def test_kernel_route_refuses_mismatched_shapes(win):
    depth, flows, Rs, ts = _meta()
    with pytest.raises(ValueError, match="shape"):
        ct.chain_trace(torch.empty((H, W - 1), device="meta"), flows, Rs, ts, 3, win["p"])
    with pytest.raises(ValueError, match="shape"):
        ct.chain_trace(depth, flows, Rs[:-1], ts, 3, win["p"])


@pytest.mark.gpu
@pytest.mark.parametrize("tracks", [True, False])
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_on_gpu(win, name, tracks):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the chain trace kernel has no CPU mode")
    dev = torch.device("cuda")
    depth, flows, Rs, ts, active_n = (x.to(dev) if isinstance(x, torch.Tensor) else x
                                      for x in _case(win, name))
    p = win["p"]
    before = ct.chain_trace_launches
    rig, inb, track = ct.chain_trace(depth, flows, Rs, ts, active_n, p, tracks=tracks)
    assert ct.chain_trace_launches == before + 1
    prig, pinb, ptrack = ct.chain_trace_reference(depth, flows, Rs, ts, active_n, p)
    assert torch.equal(inb, pinb)
    assert torch.equal(rig.isnan(), prig.isnan())
    diff = (torch.nan_to_num(rig, nan=0.0) - torch.nan_to_num(prig, nan=0.0)).abs().max()
    assert float(diff) <= RIG_ATOL
    if tracks:
        for a, b in zip(track, ptrack):
            assert _same(a.cpu(), b.cpu())
    else:
        assert track is None
    again = ct.chain_trace(depth, flows, Rs, ts, active_n, p, tracks=tracks)
    assert _same(again[0], rig)


# the benchmark's reader of the kernel's count in each call's record


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"reader_{name}", ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_benchmark_reader_of_the_launch_count():
    mod = _reader("chain_trace_per_call")
    ev = [{"event": "keyframe"},
          {"event": "vo_window", "counts": {"em.chain_trace": 3, "pose.sweep.seq": 1}},
          {"event": "vo_window", "counts": {"em.chain_trace": 4}},
          {"event": "vo_window", "counts": {"pose.sweep.seq": 1}}]  # a call with no round
    assert mod.value({"events": ev}) == pytest.approx(7 / 3, rel=1e-12)
    # a program without the kernel (the parent's), or without the record, gives nothing
    parent = {"events": [{"event": "vo_window", "counts": {"pose.sweep.seq": 1}}]}
    assert mod.value(parent) is None
    assert mod.value({"events": [{"event": "vo_window", "window_s": 0.1}]}) is None
    assert mod.value({"window_s": 1.0}) is None
