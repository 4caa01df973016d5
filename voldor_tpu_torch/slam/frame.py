"""Map primitives: Frame vertices and 7-DoF Edge constraints (port of
``voldor_tpu/slam/frame.py``; the device handles are torch tensors).

Exact semantics of slam_py/voldor_slam.py:31-79, including the covariance
hygiene the reference applies (cross-covariances between rotation /
translation / scale zeroed for stability, translation de-scaled by the
evaluation-time map scale).

Naming note: following the reference, Frame.Tcw actually stores the
camera->world (KITTI-convention) transform — the upstream field name is
kept for API familiarity (see save_poses, voldor_slam.py:321).
"""

from __future__ import annotations

import numpy as np

from voldor_tpu_torch.utils.profiling import host_read
from voldor_tpu_torch.vo.engine import host_array


class Frame:
    """Map vertex. depth/depth_conf may be host numpy maps or LAZY views
    over a solved window's device tensors (slam/system.py): the first host
    access copies them to the host, while the device tensors serve as the
    next window's depth priors with no host round trip at all."""

    def __init__(self, Tcw, depth=None, depth_conf=None, scale=1.0, is_keyframe=False):
        self.Tcw = np.asarray(Tcw).copy()
        self._depth = depth
        self._depth_conf = depth_conf
        self.depth_dev = None  # device tensors of the window that solved it
        self.conf_dev = None
        self.scale = scale
        self.is_keyframe = is_keyframe
        self.kps = None
        self.des = None

    @property
    def depth(self):
        if self._depth is None and self.depth_dev is not None:
            self._depth = host_read("frame.host_map", host_array, self.depth_dev)
        return self._depth

    @depth.setter
    def depth(self, v):
        self._depth = v

    @property
    def depth_conf(self):
        if self._depth_conf is None and self.conf_dev is not None:
            self._depth_conf = host_read("frame.host_map", host_array, self.conf_dev)
        return self._depth_conf

    @depth_conf.setter
    def depth_conf(self, v):
        self._depth_conf = v

    def set_window_maps(self, depth_dev, conf_dev):
        """Attach a solved window's output maps as device tensors."""
        self.depth_dev = depth_dev
        self.conf_dev = conf_dev

    def release_device(self):
        """Drop the device references (called when this frame stops being a
        prior keyframe, bounding device memory to the two active prior
        frames). Host copies materialize first ONLY for keyframes: they
        are the only frames whose maps are ever read again (falign links,
        save_depth_maps, viewer)."""
        if self.depth_dev is not None:
            if self.is_keyframe:
                _ = self.depth
                _ = self.depth_conf
            self.depth_dev = None
            self.conf_dev = None

    def get_scaled_depth(self):
        if self.depth is None:
            # release_device materializes host maps only for keyframes; a
            # non-keyframe that already released its device handles has no
            # depth anymore by design (see release_device).
            raise RuntimeError(
                "Frame depth map was released (non-keyframe after "
                "release_device); only keyframes retain depth maps"
            )
        return self.depth * self.scale


class Edge:
    pose_static = np.zeros(7, np.float32)
    pose_covar_null = np.diag([1e-7] * 7).astype(np.float32)  # lost tracking

    def __init__(self, fid1, fid2, pose, pose_covar, pose_eval_time_scale=1.0, edge_type="vo"):
        self.fid1 = fid1
        self.fid2 = fid2
        self.edge_type = edge_type

        pose = np.asarray(pose)
        if pose.shape == (7,):
            self.pose = pose.copy().astype(np.float32)
        elif pose.shape == (6,):
            self.pose = Edge.pose_static.copy()
            self.pose[:6] = pose
        else:
            raise ValueError("Invalid pose input for Edge")

        pose_covar = np.asarray(pose_covar)
        if pose_covar.shape == (7, 7):
            self.pose_covar = pose_covar.copy().astype(np.float32)
        elif pose_covar.shape == (6, 6):
            self.pose_covar = np.zeros((7, 7), np.float32)
            self.pose_covar[:6, :6] = pose_covar
            # synthesized scale variance from translation stds
            # (voldor_slam.py:66-68)
            self.pose_covar[6, 6] = (
                np.sqrt(pose_covar[3, 3])
                + np.sqrt(pose_covar[4, 4])
                + np.sqrt(pose_covar[5, 5])
            ) ** 2
        else:
            raise ValueError("Invalid pose covar input for Edge")

        # ignore dependencies among trans/rot/scale for stability
        # (voldor_slam.py:72-76)
        self.pose_covar[:3, 3:] = 0
        self.pose_covar[3:, :3] = 0
        self.pose_covar[:6, 6] = 0
        self.pose_covar[6, :6] = 0

        # translation measured in the evaluation-time map scale
        # (voldor_slam.py:78-79)
        self.pose[3:6] /= pose_eval_time_scale
        self.pose_covar[3:6, 3:6] /= pose_eval_time_scale**2
