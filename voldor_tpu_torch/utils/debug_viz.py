"""Per-window debug artifacts (reference --debug, voldor/voldor.cpp:378-396;
a copy of ``voldor_tpu/utils/debug_viz.py``, numpy and cv2 only).

The reference renders rigidness mosaics, inverse depth, and prior-confidence
panels to an interactive window and blocks on a key; a headless run gets
the same artifact set written to disk instead: PNG (when cv2 is available)
plus raw .npy for programmatic inspection.
"""

from __future__ import annotations

import os

import numpy as np


def _to_u8(img: np.ndarray, lo=None, hi=None) -> np.ndarray:
    img = np.asarray(img, np.float32)
    if lo is None:
        lo = np.nanmin(img)
    if hi is None:
        hi = np.nanmax(img)
    scale = 255.0 / max(hi - lo, 1e-12)
    return np.clip((img - lo) * scale, 0, 255).astype(np.uint8)


def _mosaic(maps: np.ndarray, per_row: int = 2) -> np.ndarray:
    """Tile (N, h, w) maps into a grid image (viz_img_per_row,
    config.h:33)."""
    n, h, w = maps.shape
    rows = (n + per_row - 1) // per_row
    out = np.zeros((rows * h, per_row * w), maps.dtype)
    for i in range(n):
        r, c = divmod(i, per_row)
        out[r * h : (r + 1) * h, c * w : (c + 1) * w] = maps[i]
    return out


def dump_window_debug(
    debug_dir: str,
    fid: int,
    vo_ret: dict,
    viz_img_per_row: int = 2,
    viz_depth_scale: float = 5.0,
) -> None:
    """Write one VO window's debug artifact set.

    vo_ret: the voldor() return dict (rigidness present when the engine ran
    with --save_everything). Artifacts per window: inverse depth, depth
    confidence, rigidness mosaic — PNG + npy.
    """
    os.makedirs(debug_dir, exist_ok=True)
    tag = f"window_{fid:06d}"

    depth = np.asarray(vo_ret["depth"], np.float32)
    inv_depth = viz_depth_scale / np.maximum(depth, 1e-12)
    conf = np.asarray(vo_ret["depth_conf"], np.float32)
    np.save(os.path.join(debug_dir, f"{tag}_depth.npy"), depth)
    np.save(os.path.join(debug_dir, f"{tag}_depth_conf.npy"), conf)

    panels = {
        f"{tag}_invdepth.png": _to_u8(inv_depth, 0.0, np.nanpercentile(inv_depth, 99)),
        f"{tag}_depth_conf.png": _to_u8(conf, 0.0, 1.0),
    }
    if "rigidness" in vo_ret:
        rig = np.asarray(vo_ret["rigidness"], np.float32)
        np.save(os.path.join(debug_dir, f"{tag}_rigidness.npy"), rig)
        panels[f"{tag}_rigidness.png"] = _to_u8(
            _mosaic(rig, viz_img_per_row), 0.0, 1.0
        )

    try:
        import cv2

        for name, img in panels.items():
            if name.endswith("invdepth.png"):
                img = cv2.applyColorMap(img, cv2.COLORMAP_JET)
            cv2.imwrite(os.path.join(debug_dir, name), img)
    except ImportError:
        for name, img in panels.items():
            np.save(os.path.join(debug_dir, name.replace(".png", "_u8.npy")), img)
