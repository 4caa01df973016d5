"""Synthetic scenes of the benchmark, made from a seed, in numpy alone.

A rewrite of the repository's synthetic renderer (a union of world planes
seen through a pinhole camera gives exact depth, hence exact optical flow)
with its own Rodrigues, so that nothing the program ships moves the
yardstick. The scene:

* ``stream_period``: one period of a closed, forward-dominant trajectory.
  The outbound leg's increments are drawn from the seed (rotation noise and
  a small translation jitter about a forward step); the return leg is the
  outbound's increments inverted, in reverse order, so the camera is back at
  its start pose after ``period`` flows exactly and the flows repeat.

Pose convention: increment f maps frame-f camera points to frame f+1,
``X_{f+1} = R_f X_f + t_f``; ``Ts[k]`` maps frame-0 points to frame k.
"""

from __future__ import annotations

import numpy as np


def rodrigues(rvec) -> np.ndarray:
    """Rotation matrix of a rotation vector (float64)."""
    r = np.asarray(rvec, np.float64)
    theta = float(np.linalg.norm(r))
    k = r / theta if theta > 0 else r
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    if theta == 0:
        return np.eye(3)
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def rotation_angle(R) -> float:
    """Angle of a rotation matrix, radians."""
    return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))


def intrinsics(cfg) -> np.ndarray:
    return np.array([[cfg["fx"], 0, cfg["cx"]], [0, cfg["fy"], cfg["cy"]], [0, 0, 1]], np.float64)


def planes_of(cfg):
    """The scene's world planes (unit normal, offset) from a configuration."""
    out = []
    for n, d in cfg["scene_planes"]:
        n = np.asarray(n, np.float64)
        out.append((n / np.linalg.norm(n), float(d)))
    return out


def plane_depth(K, R, t, planes, h, w) -> np.ndarray:
    """Depth map (float64) of the union of planes seen from the camera
    ``X_cam = R X_w + t``: per pixel the nearest plane in front wins."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K).T
    best = np.full((h, w), np.inf)
    for n, d in planes:
        n_c = R @ n
        d_c = d + n @ (R.T @ t)
        denom = rays @ n_c
        z = d_c / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        best = np.minimum(best, np.where(z > 0, z, np.inf))
    return best


def compose(increments) -> np.ndarray:
    """(N, 6) increments [rvec, t] -> (N + 1, 4, 4) frame-0 -> frame-k."""
    T = np.eye(4)
    Ts = [T.copy()]
    for inc in increments:
        Tf = np.eye(4)
        Tf[:3, :3] = rodrigues(inc[:3])
        Tf[:3, 3] = inc[3:6]
        T = Tf @ T
        Ts.append(T.copy())
    return np.stack(Ts)


def render_flows(K, Ts, planes, h, w):
    """Exact flows (N, h, w, 2) float32 along the transforms Ts, and each
    frame's depth (N + 1, h, w) float64."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K).T
    depths = np.stack([plane_depth(K, T[:3, :3], T[:3, 3], planes, h, w) for T in Ts])
    flows = np.empty((len(Ts) - 1, h, w, 2), np.float32)
    for f in range(len(Ts) - 1):
        X = rays * depths[f][..., None]
        Rrel = Ts[f + 1][:3, :3] @ Ts[f][:3, :3].T
        trel = Ts[f + 1][:3, 3] - Rrel @ Ts[f][:3, 3]
        X1 = X @ Rrel.T + trel
        flows[f, ..., 0] = K[0, 0] * X1[..., 0] / X1[..., 2] + K[0, 2] - xs
        flows[f, ..., 1] = K[1, 1] * X1[..., 1] / X1[..., 2] + K[1, 2] - ys
    return flows, depths


def stream_increments(seed: int, traffic: dict) -> np.ndarray:
    """(period, 6) increments of the closed stream trajectory: the seed
    draws the outbound leg's rotation noise and translation jitter; the
    return leg inverts the outbound increments in reverse order."""
    period = int(traffic["period"])
    if period % 2:
        raise ValueError("the stream's period must be even")
    half = period // 2
    rng = np.random.default_rng(seed)
    step = np.asarray(traffic["step"], np.float64)
    jitter = traffic["step_jitter"]
    out = np.zeros((period, 6))
    for f in range(half):
        out[f, :3] = rng.normal(0.0, traffic["rot_noise"], 3)
        out[f, 3:] = step * (1.0 + rng.uniform(-jitter, jitter, 3))
    for f in range(half):
        R = rodrigues(out[half - 1 - f, :3])
        t = out[half - 1 - f, 3:]
        out[half + f, :3] = -out[half - 1 - f, :3]  # the inverse rotation
        out[half + f, 3:] = -(R.T @ t)
    return out


def stream_period(seed: int, cfg: dict, traffic: dict, with_disparity: bool) -> dict:
    """One period of the stream, rendered: flows (P, h, w, 2) float32,
    depths (P, h, w) float32 of frames 0..P-1, the increments and, in
    stereo, disparities bf / depth (P, h, w) float32."""
    K, h, w = intrinsics(cfg), cfg["h"], cfg["w"]
    inc = stream_increments(seed, traffic)
    Ts = compose(inc)
    flows, depths = render_flows(K, Ts, planes_of(cfg), h, w)
    out = dict(increments=inc, flows=flows, depths=depths[:-1].astype(np.float32), Ts=Ts)
    if with_disparity:
        out["disparity"] = (cfg["bf"] / depths[:-1]).astype(np.float32)
    return out

