"""Headless map viewer: point-cloud accumulation and PLY export (a copy of
``voldor_tpu/slam/viewer.py``).

The reference viewer (slam_py/voldor_viewer.py:20-333) is a GLUT app; this
module provides the same map-inspection capabilities headlessly — the cached
point-cloud rebuild on map changes (draw_structures semantics,
voldor_viewer.py:100-159) and PLY export (voldor_viewer.py:294-314). The
live OpenGL window (``slam/gl_viewer.py``) draws from it.
"""

from __future__ import annotations

import time

import numpy as np


class VOLDOR_Viewer:
    def __init__(self, slam, depth_conf_thresh=0.95, depth_keep_ratio=0.3,
                 stride=2):
        """depth_conf_thresh / depth threshold mirror the reference's point
        filters (voldor_viewer.py:116-130)."""
        self.slam = slam
        self.depth_conf_thresh = depth_conf_thresh
        self.depth_keep_ratio = depth_keep_ratio
        self.stride = stride
        self._points = np.zeros((0, 3), np.float32)
        self._colors = np.zeros((0, 3), np.uint8)

    # ------------------------------------------------------------------
    def rebuild_points(self):
        """Rebuild the cached cloud from keyframe depths (the reference does
        this whenever _viewer_signal_map_changed fires)."""
        slam = self.slam
        pts_all, col_all = [], []
        with slam._map_lock.r_locked():
            kf_ids = list(slam.kf_ids)
            for fid in kf_ids:
                fr = slam.frames[fid]
                if fr.depth is None:
                    continue
                depth = fr.get_scaled_depth()[:: self.stride, :: self.stride]
                conf = fr.depth_conf[:: self.stride, :: self.stride]
                h, w = depth.shape
                ys, xs = np.mgrid[0 : slam.h : self.stride, 0 : slam.w : self.stride]
                keep = (conf > self.depth_conf_thresh) & (
                    depth < np.median(depth) / max(self.depth_keep_ratio, 1e-6)
                )
                rays = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)
                rays = rays @ slam.K_inv.T
                pts_c = rays * depth.reshape(-1, 1)
                pts_c = pts_c[keep.reshape(-1)]
                # Frame.Tcw holds cam->world (see frame.py)
                T = fr.Tcw
                pts_w = pts_c @ T[:3, :3].T + T[:3, 3]
                pts_all.append(pts_w.astype(np.float32))
                if fid < len(slam.images_bgri):
                    img = slam.images_bgri[fid][:: self.stride, :: self.stride]
                    col = img.reshape(-1, 3)[keep.reshape(-1)][:, ::-1]  # BGR->RGB
                else:
                    col = np.full((pts_c.shape[0], 3), 200, np.uint8)
                col_all.append(col.astype(np.uint8))
        if pts_all:
            self._points = np.concatenate(pts_all)
            self._colors = np.concatenate(col_all)
        return self._points

    def trajectory(self):
        """(N, 3) camera centers in world coordinates."""
        with self.slam._map_lock.r_locked():
            return np.stack(
                [f.Tcw[:3, 3] for f in self.slam.frames]
            ) if self.slam.frames else np.zeros((0, 3), np.float32)

    # ------------------------------------------------------------------
    def save_ply(self, path: str):
        """ASCII PLY export (voldor_viewer.py:294-314)."""
        self.rebuild_points()
        pts, cols = self._points, self._colors
        with open(path, "w") as f:
            f.write(
                "ply\nformat ascii 1.0\n"
                f"element vertex {pts.shape[0]}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                "end_header\n"
            )
            for p, c in zip(pts, cols):
                f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")
        print(f"{pts.shape[0]} points saved to {path}")

    # ------------------------------------------------------------------
    def start(self, poll_interval=0.5, max_seconds=None):
        """Headless watch loop: rebuilds the cloud when the map changes, for
        a later export."""
        t0 = time.time()
        while not self.slam.end_of_vo:
            if self.slam._viewer_signal_map_changed:
                self.slam._viewer_signal_map_changed = False
                self.rebuild_points()
            if max_seconds is not None and time.time() - t0 > max_seconds:
                break
            time.sleep(poll_interval)
        self.rebuild_points()
