"""Map checkpoint / resume (port of ``voldor_tpu/slam/checkpoint.py`` onto
the port's Frame and Edge; the same npz format, so a map saved by either
package loads in the other).

The reference has no mid-run persistence (SURVEY.md section 5) — only
terminal pose/depth exports — which makes long KITTI runs unresumable. This
module serializes the full map state (frames, edges, keyframe set, VO
cursors) to one compressed npz and restores a VOLDOR_SLAM to continue a
sequence after a crash or a planned split.

Content contract: depth/conf maps persist only for frames that still hold
them at save time. Under the pipelined VO loop that is KEYFRAMES ONLY —
non-keyframes drop their maps in Frame.release_device without a host copy
(the maps are never read again by any consumer). A reloaded map therefore
has depth on keyframes and `has_depth=False` elsewhere, exactly like the
live map it snapshotted.
"""

from __future__ import annotations

import numpy as np

from voldor_tpu_torch.slam.frame import Edge, Frame

_FORMAT_VERSION = 1


def save_map(slam, path: str) -> None:
    """Snapshot the map under the read lock (VO may keep appending after)."""
    with slam._map_lock.r_locked():
        n = len(slam.frames)
        Tcw = np.stack([f.Tcw for f in slam.frames]) if n else np.zeros((0, 4, 4))
        scales = np.asarray([f.scale for f in slam.frames], np.float32)
        is_kf = np.asarray([f.is_keyframe for f in slam.frames], bool)
        has_depth = np.asarray([f.depth is not None for f in slam.frames], bool)
        depths = {
            f"depth_{i}": slam.frames[i].depth
            for i in range(n)
            if slam.frames[i].depth is not None
        }
        confs = {
            f"conf_{i}": slam.frames[i].depth_conf
            for i in range(n)
            if slam.frames[i].depth_conf is not None
        }
        m = len(slam.edges)
        e_idx = np.asarray([[e.fid1, e.fid2] for e in slam.edges], np.int32).reshape(m, 2)
        e_pose = np.stack([e.pose for e in slam.edges]) if m else np.zeros((0, 7), np.float32)
        e_covar = np.stack([e.pose_covar for e in slam.edges]) if m else np.zeros((0, 7, 7), np.float32)
        e_type = np.asarray([e.edge_type for e in slam.edges])

        np.savez_compressed(
            path,
            format_version=_FORMAT_VERSION,
            mode=slam.mode,
            Tcw=Tcw,
            scales=scales,
            is_kf=is_kf,
            has_depth=has_depth,
            edges_idx=e_idx,
            edges_pose=e_pose,
            edges_covar=e_covar,
            edges_type=e_type,
            kf_ids=np.asarray(slam.kf_ids, np.int32),
            lc_candidates=np.asarray(slam.lc_candidates, np.int32).reshape(-1, 2),
            fid_cur=slam.fid_cur,
            fid_cur_tmpkf=slam.fid_cur_tmpkf,
            fid_cur_spakf=slam.fid_cur_spakf,
            Twc_cur=slam.Twc_cur,
            cam=np.asarray(
                [slam.fx, slam.fy, slam.cx, slam.cy, slam.basefocal], np.float32
            ),
            **depths,
            **confs,
        )
    print(f"map checkpoint ({n} frames, {m} edges) saved to {path}")


def load_map(slam, path: str) -> None:
    """Restore state saved by save_map into an initialized VOLDOR_SLAM.

    Loaders (flows/images/disps) are NOT part of the checkpoint; restart
    them with the same inputs, then resume vo/mapping threads. Raises
    ValueError for another format version or SLAM mode (the JAX package
    asserts).
    """
    z = np.load(path, allow_pickle=False)
    if int(z["format_version"]) != _FORMAT_VERSION:
        raise ValueError(f"checkpoint format {int(z['format_version'])}, expected {_FORMAT_VERSION}")
    if str(z["mode"]) != slam.mode:
        raise ValueError(f"checkpoint mode mismatch: {str(z['mode'])!r} saved, {slam.mode!r} here")

    with slam._map_lock.w_locked():
        n = z["Tcw"].shape[0]
        slam.frames = []
        for i in range(n):
            depth = z[f"depth_{i}"] if f"depth_{i}" in z else None
            conf = z[f"conf_{i}"] if f"conf_{i}" in z else None
            slam.frames.append(
                Frame(
                    z["Tcw"][i],
                    depth=depth,
                    depth_conf=conf,
                    scale=float(z["scales"][i]),
                    is_keyframe=bool(z["is_kf"][i]),
                )
            )
        slam.edges = []
        for k in range(z["edges_idx"].shape[0]):
            e = Edge.__new__(Edge)
            e.fid1 = int(z["edges_idx"][k, 0])
            e.fid2 = int(z["edges_idx"][k, 1])
            e.pose = z["edges_pose"][k].copy()
            e.pose_covar = z["edges_covar"][k].copy()
            e.edge_type = str(z["edges_type"][k])
            slam.edges.append(e)
        slam.kf_ids = [int(i) for i in z["kf_ids"]]
        slam.lc_candidates = [tuple(map(int, p)) for p in z["lc_candidates"]]
        slam.fid_cur = int(z["fid_cur"])
        slam.fid_cur_tmpkf = int(z["fid_cur_tmpkf"])
        slam.fid_cur_spakf = int(z["fid_cur_spakf"])
        slam.Twc_cur = z["Twc_cur"].copy()
    print(f"map checkpoint restored: {n} frames, {len(slam.edges)} edges")
