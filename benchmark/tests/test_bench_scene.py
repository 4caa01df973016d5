"""The seeded scenes: the stream's period closes exactly and its flows
repeat; the same seed gives the same scene."""

import json

import numpy as np

from bench_support import ROOT
import scene


def _cfg(name="kitti-stereo"):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def _traffic(name):
    return json.loads((ROOT / "benchmark" / "traffic" / f"{name}.json").read_text())


def test_stream_returns_to_its_start():
    inc = scene.stream_increments(2 ** 31 + 12345, _traffic("stream"))
    Ts = scene.compose(inc)
    np.testing.assert_allclose(Ts[-1], np.eye(4), atol=1e-12)
    # forward-dominant: the outbound leg moves the camera forward (points' z falls)
    assert np.all(inc[: len(inc) // 2, 5] < 0)


def test_stream_flows_repeat_with_the_period():
    cfg = dict(_cfg(), w=64, h=24, fx=40.0, fy=40.0, cx=32.0, cy=12.0)
    tr = _traffic("stream")
    inc = scene.stream_increments(7, tr)
    two = scene.compose(np.concatenate([inc, inc]))
    flows, depths = scene.render_flows(scene.intrinsics(cfg), two, scene.planes_of(cfg), 24, 64)
    P = len(inc)
    np.testing.assert_allclose(flows[P:], flows[:P], atol=1e-4)
    np.testing.assert_allclose(depths[P:2 * P], depths[:P], rtol=1e-9)
    assert np.all(np.isfinite(flows)) and np.all(depths > 0)


def test_same_seed_same_scene_and_disparity():
    cfg = dict(_cfg("kitti-stereo"), w=48, h=16, fx=30.0, fy=30.0, cx=24.0, cy=8.0, bf=16.0)
    a = scene.stream_period(99, cfg, _traffic("stream"), True)
    b = scene.stream_period(99, cfg, _traffic("stream"), True)
    c = scene.stream_period(100, cfg, _traffic("stream"), True)
    assert np.array_equal(a["flows"], b["flows"]) and not np.array_equal(a["flows"], c["flows"])
    np.testing.assert_allclose(a["disparity"] * a["depths"], 16.0, rtol=1e-5)

