"""The plain reference that decides ``correct``: numpy alone.

The scene is rendered from the seed (``scene.py``), so its ground truth,
the camera's true motion and each frame's true depth, is worked out again
here from the seed and never taken from the program. The program's outputs
are read only to be judged against it:

* ``pose_errors``: each published frame-to-frame motion against the true
  increment: the rotation's angle error (deg), the angle between the
  translations (deg) and, where the configuration is metric, the
  translation's error relative to its length.
* ``depth_error``: a keyframe's depth map against the true depth, as the
  median over its pixels of |s d - d_true| / d_true. A metric configuration
  takes s = 1; a monocular one takes s from the keyframe's own first
  published step (true length over published length), so depth is held to
  the scale of the poses that came out of the same window.
  ``depth_shape_error`` takes the map's own best scale instead.

Each number is compared with its limit in ``verdict``.
"""

from __future__ import annotations

import numpy as np

from scene import rodrigues, rotation_angle


def relative_motions(Tcw: np.ndarray) -> np.ndarray:
    """(N, 4, 4) camera-to-world poses -> (N - 1, 4, 4) motions from frame
    k to frame k + 1, ``X_{k+1} = M_k X_k``."""
    return np.linalg.inv(Tcw[1:]) @ Tcw[:-1]


def pose_errors(motions: np.ndarray, increments: np.ndarray, metric: bool) -> dict:
    """Per-frame errors of published motions (N, 4, 4) against the true
    increments (N, 6) [rvec, t]."""
    n = len(motions)
    rot = np.empty(n)
    tdir = np.empty(n)
    trel = np.empty(n)
    for k in range(n):
        R_gt = rodrigues(increments[k, :3])
        t_gt = increments[k, 3:6]
        R, t = motions[k, :3, :3], motions[k, :3, 3]
        rot[k] = np.degrees(rotation_angle(R @ R_gt.T))
        nt, ng = np.linalg.norm(t), np.linalg.norm(t_gt)
        if nt == 0 or not np.isfinite(nt):
            tdir[k] = 180.0
        else:
            tdir[k] = np.degrees(np.arccos(np.clip(t @ t_gt / (nt * ng), -1.0, 1.0)))
        trel[k] = np.linalg.norm(t - t_gt) / ng
    out = {"rot_err_deg": rot, "tdir_err_deg": tdir}
    if metric:
        out["t_err"] = trel
    return out


def depth_error(depth: np.ndarray, depth_true: np.ndarray, scale: float) -> float:
    """Median over the pixels of |scale * depth - true| / true; a map with
    a non-finite or non-positive pixel where the truth is finite counts as
    wholly wrong (inf)."""
    d = np.asarray(depth, np.float64) * scale
    g = np.asarray(depth_true, np.float64)
    ok = np.isfinite(g) & (g > 0)
    if not np.all(np.isfinite(d[ok])):
        return float("inf")
    return float(np.median(np.abs(d[ok] - g[ok]) / g[ok]))


def depth_shape_error(depth: np.ndarray, depth_true: np.ndarray) -> float:
    """``depth_error`` after the map's own best scale (the median ratio of
    the truth to the map): the error of the map's shape alone, whatever
    scale the monocular estimate has drifted to."""
    d = np.asarray(depth, np.float64)
    g = np.asarray(depth_true, np.float64)
    ok = np.isfinite(g) & (g > 0)
    if not np.all(np.isfinite(d[ok])) or not np.all(d[ok] > 0):
        return float("inf")
    return depth_error(d, g, float(np.median(g[ok] / d[ok])))


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [(name, value, limit, kind)]) with kind "max" (the value
    may not exceed the limit) or "min" (may not fall below it). A number
    that is missing or not finite fails."""
    rows, ok = [], True
    for name, spec in limits.items():
        v = numbers.get(name)
        kind, lim = spec["kind"], spec["limit"]
        good = v is not None and np.isfinite(v) and (v <= lim if kind == "max" else v >= lim)
        ok &= bool(good)
        rows.append((name, v, lim, kind))
    return ok, rows
