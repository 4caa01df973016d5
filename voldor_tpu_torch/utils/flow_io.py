"""Middlebury .flo optical-flow IO and HSV visualization (a copy of
``voldor_tpu/utils/flow_io.py``).

Parity with slam_py/flow_utils.py:10-37 (magic 202021.25, little-endian
w/h/int32 header, (h, w, 2) float32 payload).
"""

from __future__ import annotations

import numpy as np

FLO_MAGIC = 202021.25


def load_flow(path: str) -> np.ndarray | None:
    with open(path, "rb") as f:
        magic = float(np.fromfile(f, np.float32, count=1)[0])
        if magic != FLO_MAGIC:
            return None
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=h * w * 2)
        return data.reshape(h, w, 2)


def save_flow(path: str, flow: np.ndarray) -> None:
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.asarray([FLO_MAGIC], np.float32).tofile(f)
        np.asarray([w], np.int32).tofile(f)
        np.asarray([h], np.int32).tofile(f)
        np.ascontiguousarray(flow, np.float32).tofile(f)


def vis_flow(flow: np.ndarray, scale: float = 0.0) -> np.ndarray:
    """HSV flow visualization -> BGR float image in [0, 1]."""
    fx, fy = flow[..., 0], flow[..., 1]
    mag = np.sqrt(fx * fx + fy * fy)
    ang = (np.degrees(np.arctan2(fy, fx)) + 360.0) % 360.0
    if scale == 0:
        rng = mag.max() - mag.min()
        mag = (mag - mag.min()) / (rng if rng > 0 else 1.0)
    else:
        mag = mag / scale
    try:
        import cv2

        hsv = cv2.merge([ang.astype(np.float32), mag.astype(np.float32), np.ones_like(mag, np.float32)])
        return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
    except ImportError:
        # minimal fallback: grayscale magnitude
        return np.repeat(mag[..., None], 3, axis=-1).astype(np.float32)
