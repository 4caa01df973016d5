"""VOLDOR_SLAM: the SLAM orchestrator of the port (port of
``voldor_tpu/slam/system.py``).

Same attributes, thresholds and mode configs as the JAX package's
``VOLDOR_SLAM``, plus a ``device`` keyword: the frame/edge graph,
covisibility-gated VO stepping from on-device scores, temporal and spatial
keyframes, the mono-scaled Huber disparity-scale fit, the pipelined window
dispatch (one window in flight across ``process_vo`` calls, invalidated by
``_map_version``), the file loaders of the demo, loop closure (ORB features,
BoW retrieval and a geometry check on each keyframe, on the host), and the
mapping half: frame-alignment links (``establish_*`` over ``falign_pairs``),
the priority-matrix ``mapping_thread`` and ``solve_pgo`` over ``pgo``.

Loop closure, the image loader and the PNG disparity loader need cv2; they
raise ``RuntimeError`` without it. With ``debug_dir`` set, every window's
depth, confidence and rigidness maps are written there
(``utils/debug_viz.py``). The flow loader, and the disparity loader on a
.flo directory, read through the native C++ prefetcher
(``native/io.py``), or the Python .flo reader where it cannot be built;
the JAX package's TPU compile warm-up thread has no counterpart.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from voldor_tpu_torch.config import VoldorConfig
from voldor_tpu_torch.falign import api as falign_api
from voldor_tpu_torch.ops.image import gaussian_blur
from voldor_tpu_torch.pgo import api as pgo_api
from voldor_tpu_torch.slam.frame import Edge, Frame
from voldor_tpu_torch.slam.huber import draw_scale_subsample, huber_fit
from voldor_tpu_torch.slam.loop_closure import BowRetriever, load_vocabulary
from voldor_tpu_torch.slam.rwlock import RWLock
from voldor_tpu_torch.slam.slam_utils import (
    R_to_rvec,
    T6_to_T44,
    T44_to_T6,
    geometry_check,
    polish_T44,
)
from voldor_tpu_torch.utils import profiling
from voldor_tpu_torch.utils.flow_io import load_flow
from voldor_tpu_torch.utils.metrics import MetricsLogger
from voldor_tpu_torch.vo.api import voldor_dispatch
from voldor_tpu_torch.vo.engine import DeviceMap, resolve_device


def _cv2(what: str):
    """cv2, or a RuntimeError naming what needs it."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f"{what} needs cv2 (OpenCV), which does not import here") from e
    return cv2


class VOLDOR_SLAM:
    def __init__(self, mode: str = "mono", device=None):
        self.voldor_winsize = 5

        # key-frame selection (voldor_slam.py:88-91)
        self.vostep_visibility_thresh = 0.8
        self.spakf_visibility_thresh = 0.8
        self.depth_covis_conf_thresh = 0.1

        # mono-scaled (voldor_slam.py:93-95)
        self.depth_scaling_max_pixels = 10000
        self.depth_scaling_conf_thresh = 0.3
        # the fit's pixel subsample (the JAX package draws from np.random's
        # global state); any object with .permutation(n)
        self.depth_scaling_rng = np.random.default_rng(0)

        # voldor related, set before set_cam_params (voldor_slam.py:97-99)
        self.voldor_pose_sample_min_disp = 1.0
        self.voldor_pose_sample_max_disp = 200.0

        # pgo (voldor_slam.py:101-103)
        self.pgo_refine_kf_interval = 10
        self.pgo_local_kf_winsize = 50

        # frame alignment (voldor_slam.py:105-113; system.py:61-91)
        self.falign_vbf_factor = 5
        self.falign_crw = 10
        self.falign_local_link_stride = 4
        self.falign_local_depth_gblur_width = 3
        self.falign_local_image_gblur_width = 5
        self.falign_lc_link_stride = 3
        self.falign_lc_depth_gblur_width = 5
        self.falign_lc_image_gblur_width = 9
        self.falign_coarse_stride = 6
        self.falign_fine_iters = 12
        self.mp_link_batch_min = 12
        self.mp_link_max_delay_s = 3.0

        # loop closure (voldor_slam.py:115-119; system.py:99-129)
        self.lc_bow_score_thresh = 0.55
        self.lc_bow_score_thresh_pretrained = 0.35
        self.lc_geo_inlier_thresh = 0.4
        self.lc_geo_inlier_cold_thresh = 0.5
        self.lc_min_kf_distance = 20
        self.lc_link_visibility_thresh = 0.65
        self.lc_link_consistency_thresh = 0.75

        # mapping (voldor_slam.py:121-128)
        self.mp_realtime_link_thresh = 0.95
        self.mp_no_link_thresh = 0.5
        self.mp_spatial_sigma = 10
        self.mp_temporal_sigma = 30
        self.mp_lc_sigma = 2
        self.mp_link_visibility_thresh = 0.75
        self.mp_link_consistency_thresh = 0.85

        # global flags (voldor_slam.py:130-137)
        self.mode = mode
        self.device = resolve_device(device)
        self.use_image_info = True
        self.end_of_vo = False
        self.voldor_user_config = ""
        self.disable_dp = False
        self.disable_local_mapping = False

        # internal
        self.metrics = MetricsLogger()  # enable with .metrics.open(path)
        self.debug_dir = None  # per-window debug dumps (utils/debug_viz.py)
        self.vo_pose_warmstart = True  # constant-velocity window pose init
        # cross-window VO pipelining (process_vo docstring): one window is
        # kept in flight across calls; _map_version invalidates it when a
        # map write-back rebases the map under the dispatched priors
        self.vo_pipeline = True
        self._vo_pending = None
        # flow upload-ahead: fid -> tensor on self.device, enqueued right
        # after a window's dispatch (_flow_upload_ahead)
        self._flow_dev_cache = {}
        self._flow_transfer_f16 = None  # resolved lazily from the config
        self._map_version = 0
        self._use_loop_closure = False
        self._block_vo_signal = False
        self._map_lock = RWLock()
        self._viewer_signal_map_changed = False
        self.show_debug = False

        if mode == "stereo":
            self.voldor_config = (
                "--silent --meanshift_kernel_var 0.1 --disp_delta 1 --delta 0.2 --max_iters 4 "
            )
            self.mp_realtime_link_thresh = 1
            self.pgo_refine_kf_interval = 20
        elif mode == "mono-scaled":
            self.voldor_config = (
                "--silent --meanshift_kernel_var 0.2 --delta 1.5 --max_iters 5 "
            )
            self.mp_realtime_link_thresh = 1
            self.pgo_refine_kf_interval = 20
        elif mode == "mono":
            self.voldor_config = (
                "--silent --meanshift_kernel_var 0.2 --delta 1.5 --max_iters 5 "
            )
            self.mp_realtime_link_thresh = 0.95
            self.pgo_refine_kf_interval = 10
        else:
            raise ValueError(f"Unknown SLAM mode - {mode}")

        self.flows: list[np.ndarray] = []
        self.images_grayf: list[np.ndarray] = []
        self.images_bgri: list[np.ndarray] = []
        self.disps: list[np.ndarray] = []
        self.flow_loader_pt = -1
        self.image_loader_pt = -1
        self.disp_loader_pt = -1
        self.lc_candidates: list[tuple[int, int]] = []

        self.fx = self.fy = self.cx = self.cy = 0.0
        self.basefocal = 0.0
        self.N_FRAMES = float("nan")
        self.w = self.h = 0

        self.fid_cur = 0
        self.fid_cur_tmpkf = -1
        self.fid_cur_spakf = -1
        self.Twc_cur = np.eye(4, dtype=np.float32)

        self.frames: list[Frame] = []
        self.edges: list[Edge] = []
        self.kf_ids: list[int] = []

    # ------------------------------------------------------------------
    def set_cam_params(self, fx, fy, cx, cy, basefocal="auto", rescale=1.0):
        """(voldor_slam.py:193-205) — auto virtual basefocal = 0.5*focal."""
        self.fx = fx * rescale
        self.fy = fy * rescale
        self.cx = cx * rescale
        self.cy = cy * rescale
        if basefocal == "auto" or basefocal <= 0:
            self.basefocal = (fx + fy) * 0.25 * rescale
        else:
            self.basefocal = basefocal * rescale
        self.K = np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], np.float32
        )
        self.K_inv = np.linalg.inv(self.K)
        self.voldor_config += (
            f"--pose_sample_min_depth {self.basefocal / self.voldor_pose_sample_max_disp} "
            f"--pose_sample_max_depth {self.basefocal / self.voldor_pose_sample_min_disp} "
        )
        print(
            f"Camera parameters set to {self.fx}, {self.fy}, {self.cx}, "
            f"{self.cy}, {self.basefocal}"
        )

    # ------------------------------------------------------------------
    # loader sync + threads (voldor_slam.py:207-315). The loaders feed the
    # lists and advance the *_loader_pt counters; callers may also fill the
    # lists directly.
    def _loader_sync(self, pt_attr, fid_query, no_block, block_when_uninit):
        if (getattr(self, pt_attr) == -1 and not block_when_uninit) or (
            fid_query >= self.N_FRAMES - 1
        ):
            return False
        while getattr(self, pt_attr) <= fid_query:
            if no_block:
                return False
            time.sleep(0.01)
        return True

    def flow_loader_sync(self, fid_query, no_block=False, block_when_uninit=False):
        return self._loader_sync("flow_loader_pt", fid_query, no_block, block_when_uninit)

    def image_loader_sync(self, fid_query, no_block=False, block_when_uninit=False):
        return self._loader_sync("image_loader_pt", fid_query, no_block, block_when_uninit)

    def disp_loader_sync(self, fid_query, no_block=False, block_when_uninit=False):
        return self._loader_sync("disp_loader_pt", fid_query, no_block, block_when_uninit)

    def flow_loader(self, flow_path, resize=1.0, n_cache=100, range=(0, 0)):
        """Feeds self.flows with bounded read-ahead (system.py:261-285): the
        directory's .flo files in sorted order (``range`` slices them),
        resized by ``resize`` with the flow vectors scaled alike. Sets
        N_FRAMES, h and w from the first file. The files are read by the
        native C++ prefetcher (``native/io.py``) when it builds, else by the
        Python .flo reader."""
        from voldor_tpu_torch.native.io import NativeFlowDir

        src = NativeFlowDir(flow_path, range=range)
        self.flow_loader_pt = 0
        print(f"{len(src)} flows loaded" + (" (native IO)" if src.native else ""))
        self.N_FRAMES = len(src) + 1
        self.h = int(src.h * resize)
        self.w = int(src.w * resize)
        i = 0  # (`range` shadows the builtin: the upstream API's name)
        try:
            while i < len(src):
                while len(self.flows) - self.fid_cur > n_cache:
                    time.sleep(0.01)
                flow = src.get(i)
                i += 1
                if flow.shape[0] != self.h or flow.shape[1] != self.w:
                    flow = self._resize_flow(flow, self.w, self.h)
                self.flows.append(flow)
                self.flow_loader_pt += 1
        finally:
            src.close()

    @staticmethod
    def _resize_flow(flow, w, h):
        """(system.py:287-295)"""
        sx, sy = w / flow.shape[1], h / flow.shape[0]
        flow = _cv2("resizing flows").resize(flow, (w, h))
        flow[..., 0] *= sx
        flow[..., 1] *= sy
        return flow

    def image_loader(self, image_path, n_cache=100, range=(0, 0)):
        """Feeds images_bgri (uint8 BGR) and images_grayf (float32 gray in
        [0, 1]) at the flows' size (system.py:297-316)."""
        cv2 = _cv2("the image loader")
        if self.h == 0 or self.w == 0:
            raise RuntimeError("Need start optical flow loader first.")
        self.image_loader_pt = 0
        image_fn_list = sorted(os.listdir(image_path))
        if range != (0, 0):
            image_fn_list = image_fn_list[range[0]:range[1]]
        print(f"{len(image_fn_list)} images loaded")
        for fn in image_fn_list:
            while len(self.images_grayf) - self.fid_cur > n_cache or self.flow_loader_pt <= 0:
                time.sleep(0.01)
            img = cv2.imread(os.path.join(image_path, fn), cv2.IMREAD_COLOR)
            if img.shape[0] != self.h or img.shape[1] != self.w:
                img = cv2.resize(img, (self.w, self.h))
            self.images_bgri.append(img.copy())
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY).astype(np.float32) / 255.0
            self.images_grayf.append(img)
            self.image_loader_pt += 1

    def disp_loader(self, disp_path, n_cache=100, range=(0, 0)):
        """Feeds self.disps at the flows' size (system.py:318-358): .flo
        files (KITTI stereo: the negated x-flow) or 16-bit .png (value /
        256), resized with the disparity scaled by the width ratio."""
        if self.h == 0 or self.w == 0:
            raise RuntimeError("Need start optical flow loader first.")
        self.disp_loader_pt = 0
        disp_fn_list = sorted(os.listdir(disp_path))
        if range != (0, 0):
            disp_fn_list = disp_fn_list[range[0]:range[1]]
        print(f"{len(disp_fn_list)} disparities loaded")
        # .flo disparities (KITTI stereo: the negated x-flow) are a second
        # flow directory: the native prefetcher reads them too
        src = None
        if disp_fn_list and all(f.endswith(".flo") for f in disp_fn_list):
            from voldor_tpu_torch.native.io import NativeFlowDir

            src = NativeFlowDir(disp_path, range=range)
        try:
            for i, fn in enumerate(disp_fn_list):
                while len(self.disps) - self.fid_cur > n_cache or self.flow_loader_pt <= 0:
                    time.sleep(0.01)
                if src is not None:
                    disp = np.ascontiguousarray(-src.get(i)[..., 0])
                elif fn.endswith(".flo"):
                    disp = np.ascontiguousarray(-load_flow(os.path.join(disp_path, fn))[..., 0])
                elif fn.endswith(".png"):
                    cv2 = _cv2("the PNG disparity loader")
                    disp = cv2.imread(os.path.join(disp_path, fn), cv2.IMREAD_UNCHANGED)
                    disp = disp.astype(np.float32) / 256.0
                else:
                    raise ValueError(f"Unsupported disparity format {fn}")
                if disp.shape[0] != self.h or disp.shape[1] != self.w:
                    disp = _cv2("resizing disparities").resize(disp, (self.w, self.h)) * (
                        self.w / disp.shape[1])
                self.disps.append(disp)
                self.disp_loader_pt += 1
        finally:
            if src is not None:
                src.close()

    # ------------------------------------------------------------------
    def save_poses(self, file_path="./output_pose.txt", format="KITTI"):
        """(voldor_slam.py:317-329)"""
        with open(file_path, "w") as f:
            for fid in range(int(self.N_FRAMES)):
                T = self.frames[fid].Tcw
                if format == "KITTI":
                    f.write(" ".join(str(v) for v in T[:3, :4].reshape(-1)))
                    f.write("\n")
                elif format == "TartanAir":
                    q = _quat_xyzw_from_R(T[:3, :3])
                    t = T[:3, 3]
                    f.write(f"{t[2]} {t[0]} {t[1]} {q[2]} {q[0]} {q[1]} {q[3]}\n")
        print(f"Camera poses saved to {file_path} with {format} format")

    def save_depth_maps(self, save_dir="./depths", zfill=6):
        """(voldor_slam.py:331-337)"""
        os.makedirs(save_dir, exist_ok=True)
        for fid in self.kf_ids:
            np.save(
                os.path.join(save_dir, f"{str(fid).zfill(zfill)}_depth.npy"),
                self.frames[fid].get_scaled_depth(),
            )
            np.save(
                os.path.join(save_dir, f"{str(fid).zfill(zfill)}_depth_conf.npy"),
                self.frames[fid].depth_conf,
            )
        print(f"{len(self.kf_ids)} depth maps saved to {save_dir}")

    # ------------------------------------------------------------------
    def enable_loop_closure(self, voc_path=None, retriever=None):
        """Loop closure (system.py:395-432): every keyframe's ORB features
        are queried against a retriever and, past the score, keyframe
        distance and geometry gates, become lc_candidates for the mapping
        thread. voc_path, when it names a DBoW2/3 vocabulary (text
        ORBvoc.txt[.gz] or binary ORBvoc.bin), backs a BowRetriever with it
        and lowers the score threshold to the pretrained one; otherwise the
        built-in online-learned vocabulary. Raises RuntimeError without
        cv2, where the JAX package prints a note and runs without loop
        closure: a run that asked for it does not silently lose it."""
        self.feature_detector = _cv2("loop closure (ORB features, geometry check)").ORB_create()
        if voc_path and retriever is None:
            try:
                voc = load_vocabulary(voc_path)
                retriever = BowRetriever(vocabulary=voc)
                self.lc_bow_score_thresh = self.lc_bow_score_thresh_pretrained
                print(f"Loaded vocabulary from {voc_path} "
                      f"({voc.n_words} words, k={voc.k} L={voc.L}, "
                      f"score thresh -> {self.lc_bow_score_thresh})")
            except (OSError, ValueError) as e:
                print(f"Note: could not load vocabulary '{voc_path}' ({e}) — "
                      "using the built-in online-learned vocabulary.")
        # not `retriever or ...`: an empty retriever is falsy (__len__)
        self.retriever = retriever if retriever is not None else BowRetriever()
        self._use_loop_closure = True

    def solve_pgo(self, fid_start=0):
        """(voldor_slam.py:361-414; system.py:435-525) The graph is
        snapshot under the write lock, solved with no lock held, and applied
        under a short write lock. Frames the VO thread appended during the
        solve chain off the last snapshot frame by pure VO edges, so they
        and Twc_cur are rebased by that frame's world-frame correction;
        _map_version invalidates in-flight VO priors built on the old map.
        A ``pgo.solve`` pass of the mapping trace (``_map_pass``)."""
        with self._map_pass("pgo.solve"):
            self._solve_pgo(fid_start)

    def _solve_pgo(self, fid_start):
        with self._map_lock.w_locked(), profiling.span("pgo.snapshot"):
            n_frames_total = len(self.frames) + 1  # +1 for Twc_cur
            n_edges_total = len(self.edges)
            n_frames = n_frames_total - fid_start
            if n_frames <= 0:
                return
            poses_idx = np.zeros(n_frames, np.int32)
            poses = np.zeros((n_frames, 7), np.float32)
            edges_idx = np.zeros((n_edges_total, 2), np.int32)
            edges_pose = np.zeros((n_edges_total, 7), np.float32)
            edges_covar = np.zeros((n_edges_total, 7, 7), np.float32)

            for i in range(fid_start, n_frames_total - 1):
                poses_idx[i - fid_start] = i
                poses[i - fid_start, :6] = T44_to_T6(self.frames[i].Tcw)
                poses[i - fid_start, 6] = np.log(self.frames[i].scale)
            poses_idx[n_frames - 1] = n_frames_total - 1
            poses[n_frames - 1, :6] = T44_to_T6(np.linalg.inv(self.Twc_cur))
            poses[n_frames - 1, 6] = np.log(self.frames[n_frames_total - 2].scale)

            n_edges = 0
            for e in self.edges:
                if fid_start <= e.fid1 < n_frames_total and fid_start <= e.fid2 < n_frames_total:
                    edges_idx[n_edges] = [e.fid1, e.fid2]
                    edges_pose[n_edges] = e.pose
                    edges_covar[n_edges] = e.pose_covar
                    n_edges += 1
            if n_edges == 0:
                return
        profiling.count("pgo_poses", int(n_frames))
        profiling.count("pgo_edges", int(n_edges))

        t_solve = time.perf_counter()
        with profiling.span("pgo.lm"):
            poses_ret = pgo_api.pgo(
                poses=poses, poses_idx=poses_idx, edges_idx=edges_idx[:n_edges],
                edges_pose=edges_pose[:n_edges], edges_covar=edges_covar[:n_edges],
                optimize_7dof=self.mode == "mono", device=self.device,
            )
        t_solve = time.perf_counter() - t_solve

        with self._map_lock.w_locked(), profiling.span("pgo.apply"):
            last = n_frames_total - 2  # last real frame in the snapshot
            # world-frame correction of the last snapshot frame against its
            # current pose: frames appended since are relative to it
            Tcw_last_new = T6_to_T44(poses_ret[n_frames - 2, :6]).astype(np.float32)
            D = Tcw_last_new @ np.linalg.inv(self.frames[last].Tcw)
            ds = float(np.exp(poses_ret[n_frames - 2, 6])) / self.frames[last].scale

            for i in range(n_frames - 1):
                self.frames[i + fid_start].Tcw = T6_to_T44(poses_ret[i, :6]).astype(np.float32)
                self.frames[i + fid_start].scale = float(np.exp(poses_ret[i, 6]))
            for i in range(n_frames_total - 1, len(self.frames)):
                self.frames[i].Tcw = (D @ self.frames[i].Tcw).astype(np.float32)
                self.frames[i].scale = float(self.frames[i].scale * ds)
            # rebase the live camera by the same correction
            self.Twc_cur = np.linalg.inv(D @ np.linalg.inv(self.Twc_cur)).astype(np.float32)
            self._map_version += 1
            print(f"solve pgo {fid_start}-{n_frames_total}, n_frames={n_frames}, n_edges={n_edges}")
            self.metrics.log(
                "pgo", fid_start=int(fid_start), n_frames=int(n_frames),
                n_edges=int(n_edges), solve_s=round(t_solve, 4),
            )

    # ------------------------------------------------------------------
    def _gblur(self, img, k):
        """The SLAM layer's Gaussian blur, on the host (system.py:912-922):
        cv2.GaussianBlur where cv2 imports, the port's own separable blur
        (cv2's sigma formula and borders) otherwise. The two differ at
        width 9, where OpenCV tables its own taps."""
        try:
            import cv2
        except ImportError:
            return gaussian_blur(torch.from_numpy(np.ascontiguousarray(img, np.float32)), k).numpy()
        return cv2.GaussianBlur(img, (k, k), 0)

    def establish_local_links(self, kf_ids):
        """(voldor_slam.py:538-594)"""
        self.establish_links_batch([tuple(kf_ids)], kind="local")

    def establish_lc_links(self, kf_ids):
        """(voldor_slam.py:597-675) two-stage: geometry only, then
        photometric; mono normalises the depth medians to 10."""
        self.establish_links_batch([tuple(kf_ids)], kind="lc")

    def establish_links_batch(self, pair_list, kind="local"):
        """Solve many independent 2-keyframe link problems as the lanes of
        one falign_pairs batch (system.py:928-1091): same per-pair gates,
        metrics events and edges as one problem at a time.

        kind: 'local' (one photo + geo stage, pose init from the current
        map) or 'lc' (geometry, then photometric from its result, identity
        init, mono median-10 depth normalisation). A ``map.links`` pass of
        the mapping trace (``_map_pass``)."""
        if not pair_list:
            return
        with self._map_pass("map.links"):
            self._establish_links_batch(pair_list, kind)

    def _establish_links_batch(self, pair_list, kind):
        is_lc = kind == "lc"
        stride = self.falign_lc_link_stride if is_lc else self.falign_local_link_stride
        d_blur = self.falign_lc_depth_gblur_width if is_lc else self.falign_local_depth_gblur_width
        i_blur = self.falign_lc_image_gblur_width if is_lc else self.falign_local_image_gblur_width
        P = len(pair_list)

        with self._map_lock.r_locked():
            depths, weights, poses_init, images, scalings = [], [], [], [], []
            for kf_ids in pair_list:
                if is_lc:
                    print("Loop closure at ", list(kf_ids))
                for fid in kf_ids:
                    depth = self.frames[fid].get_scaled_depth()
                    if is_lc and self.mode == "mono":
                        sc = 10 / np.median(depth)
                        depth = depth * sc
                        scalings.append(sc)
                    elif is_lc:
                        scalings.append(1.0)
                    depths.append(self._gblur(depth, d_blur))
                    weights.append(self.frames[fid].depth_conf)
                    if not is_lc:
                        poses_init.append(T44_to_T6(
                            np.linalg.inv(self.frames[kf_ids[0]].Tcw) @ self.frames[fid].Tcw))
                    if self.use_image_info:
                        if not self.image_loader_sync(fid):
                            raise RuntimeError("Image loader not working or files are missing.")
                        images.append(self._gblur(self.images_grayf[fid], i_blur))

            def shape_pairs(lst):
                return np.stack(lst).reshape(P, 2, *lst[0].shape)

            kwargs = dict(
                depths=shape_pairs(depths), fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy,
                weights=shape_pairs(weights), optimize_7dof=self.mode == "mono",
                stride=stride, vbf=self.basefocal * self.falign_vbf_factor,
                crw=self.falign_crw, device=self.device,
            )

            def add_c2f(kw):
                # coarse-to-fine only on photometric solves (system.py:1029-1039)
                if (self.falign_coarse_stride and self.falign_coarse_stride > stride
                        and "images" in kw):
                    kw["coarse_stride"] = self.falign_coarse_stride
                    kw["fine_iters"] = self.falign_fine_iters
                return kw

            if is_lc:
                rets = falign_api.falign_pairs(**kwargs)  # stage 1: geometry only
                if self.use_image_info:
                    kwargs["images"] = shape_pairs(images)
                    kwargs["poses_init"] = np.stack([r["poses_ret"] for r in rets])
                    rets = falign_api.falign_pairs(**add_c2f(kwargs))  # stage 2: photo
            else:
                kwargs["poses_init"] = np.stack(poses_init).astype(np.float32).reshape(P, 2, 6)
                if self.use_image_info:
                    kwargs["images"] = shape_pairs(images)
                rets = falign_api.falign_pairs(**add_c2f(kwargs))

            c_thr = self.lc_link_consistency_thresh if is_lc else self.mp_link_consistency_thresh
            v_thr = self.lc_link_visibility_thresh if is_lc else self.mp_link_visibility_thresh
            for i, kf_ids in enumerate(pair_list):
                sub = rets[i]
                consistency = np.nanmean(sub["consistency_mat"])
                visibility = np.nanmean(sub["visibility_mat"])
                gate_cv = consistency < c_thr or visibility < v_thr
                gate_rank = not gate_cv and bool(np.any(
                    np.linalg.matrix_rank(sub["poses_covar"].astype(np.float64))
                    != sub["poses_covar"].shape[1]))
                self.metrics.log(
                    "lc_link" if is_lc else "local_link",
                    kf_ids=[int(k) for k in kf_ids],
                    consistency=round(float(consistency), 4),
                    visibility=round(float(visibility), 4),
                    accepted=not (gate_cv or gate_rank),
                    rejected_by="consistency/visibility" if gate_cv
                                else ("covar_rank" if gate_rank else None),
                )
                if is_lc:
                    tag = ", rejected" if (gate_cv or gate_rank) else ""
                    print(f"Loop closure registration score = "
                          f"{consistency:.4f} / {visibility:.4f}{tag}")
                if gate_cv or gate_rank:
                    continue
                if is_lc:
                    profiling.count("lc_links")
                med = scalings[2 * i: 2 * i + 2] if is_lc and self.mode == "mono" else None
                self._append_falign_edges(
                    list(kf_ids), sub, edge_type="falign-lc" if is_lc else "falign-local",
                    median_scaling=med)

    def _append_falign_edges(self, kf_ids, falign_ret, edge_type, median_scaling=None):
        """(system.py:1093-1112)"""
        Tcw = T6_to_T44(falign_ret["poses_ret"])
        for i1 in range(len(kf_ids) - 1):
            for i2 in range(i1 + 1, len(kf_ids)):
                Tc1c2 = np.linalg.inv(Tcw[i2]) @ Tcw[i1]
                pose7 = np.zeros(7, np.float32)
                pose7[:6] = T44_to_T6(Tc1c2)
                sf1 = falign_ret["scaling_factor"][i1]
                sf2 = falign_ret["scaling_factor"][i2]
                if median_scaling is not None:
                    sf1 = sf1 * median_scaling[i1]
                    sf2 = sf2 * median_scaling[i2]
                f1_scale = self.frames[kf_ids[i1]].scale * sf1
                f2_scale = self.frames[kf_ids[i2]].scale * sf2
                pose7[6] = np.log(f2_scale / f1_scale)
                self.edges.append(
                    Edge(kf_ids[i1], kf_ids[i2], pose7, falign_ret["poses_covar"][i2],
                         pose_eval_time_scale=float(np.sqrt(f1_scale * f2_scale)),
                         edge_type=edge_type))

    # ------------------------------------------------------------------
    def _vo_window_inputs(self):
        """Assemble the dispatch inputs for the window starting at fid_cur
        (the prior/warm-start prep of voldor_slam.py:416-447). Prior maps
        prefer the frames' device tensors (no host round trip); the
        covisibility inputs ride the same dispatch (ops/covis.py)."""
        depth_priors, depth_prior_pconfs, depth_prior_poses = [], [], []
        dpkf_list = []
        if not self.disable_dp:
            if self.fid_cur_tmpkf >= 0:
                dpkf_list.append(self.fid_cur_tmpkf)
            if self.fid_cur_spakf >= 0 and self.fid_cur_spakf != self.fid_cur_tmpkf:
                dpkf_list.append(self.fid_cur_spakf)
        for fid in dpkf_list:
            f = self.frames[fid]
            if f.depth_dev is not None:
                depth_priors.append(DeviceMap(f.depth_dev, f.scale))
                depth_prior_pconfs.append(f.conf_dev)
            else:
                depth_priors.append(f.get_scaled_depth())
                depth_prior_pconfs.append(f.depth_conf)
            depth_prior_poses.append(
                T44_to_T6(np.linalg.inv(self.Twc_cur @ f.Tcw))
            )

        if not self.flow_loader_sync(
            min(self.fid_cur + self.voldor_winsize - 1, int(self.N_FRAMES) - 2)
        ):
            raise RuntimeError("Flow loader not working or files are missing.")
        if self.mode == "stereo" and not self.disp_loader_sync(self.fid_cur):
            raise RuntimeError("Disparity loader not working or files are missing.")

        # Constant-velocity pose warm start (system.py:561-575): every
        # window transition initializes at the last solved transition's
        # relative pose. The reference always starts from zero
        # (voldor.cpp:130).
        poses_init = None
        if self.vo_pose_warmstart and self.fid_cur >= 1 and depth_priors:
            # frames[] holds 0..fid_cur-1; the current frame's
            # world->cam is Twc_cur (frames[fid] appends after solve)
            rel = self.Twc_cur @ self.frames[self.fid_cur - 1].Tcw
            poses_init = np.tile(
                np.asarray(T44_to_T6(rel), np.float32),
                (self.voldor_winsize, 1),
            )

        # on-device covisibility (ops/covis.py): the vo_step gate over the
        # window's own output depth and, when a spatial KF exists, the
        # spakf retention gate for every candidate step — both come back
        # with the solve's scalars, so no dense map blocks window stepping
        covis_spec = {"conf_thresh": self.depth_covis_conf_thresh}
        if self.fid_cur_spakf >= 0:
            fs = self.frames[self.fid_cur_spakf]
            if fs.depth_dev is not None:
                sdep, sconf = fs.depth_dev, fs.conf_dev
            else:
                sdep, sconf = fs.depth, fs.depth_conf
            covis_spec["spakf"] = (sdep, sconf, fs.scale, self.Twc_cur @ fs.Tcw)

        return dict(
            # per-transition list: tensors from the upload-ahead cache when
            # present, host numpy otherwise (engine._stack_flows unifies
            # them with identical numerics)
            flows=self._window_flows(),
            disparity=self.disps[self.fid_cur] if self.mode == "stereo" else None,
            depth_priors=depth_priors or None,
            depth_prior_pconfs=depth_prior_pconfs or None,
            depth_prior_poses=(
                np.stack(depth_prior_poses) if depth_prior_poses else None
            ),
            poses_init=poses_init,
            covis_spec=covis_spec,
            fid=int(self.fid_cur),
        )

    def _engine_config(self) -> VoldorConfig:
        cfg = VoldorConfig(fx=1.0, fy=1.0, cx=0.0, cy=0.0)
        cfg.read_config(self.voldor_config + " " + self.voldor_user_config)
        return cfg

    def _window_flows(self):
        """Flows entry for the window dispatch: a per-transition list
        mixing upload-ahead tensors and host numpy (system.py:621-634). An
        engine-side --resize_factor != 1 is rejected by the engine's
        init."""
        lo = self.fid_cur
        hi = min(self.fid_cur + self.voldor_winsize, len(self.flows))
        return [self._flow_dev_cache.get(f, self.flows[f]) for f in range(lo, hi)]

    def _flow_upload_ahead(self):
        """Enqueue host-to-device copies of the flows the NEXT window may
        need, right after a window was dispatched (system.py:636-668): from
        pinned host memory, non-blocking, on the CUDA device. Entries
        behind fid_cur are dropped. Copies round through the config's
        transfer dtype, so the solve sees the same flows either way
        (engine._stack_flows)."""
        if self._flow_transfer_f16 is None:
            self._flow_transfer_f16 = self._engine_config().transfer_dtype == "float16"
        for f in list(self._flow_dev_cache):
            if f < self.fid_cur:
                del self._flow_dev_cache[f]
        # len(self.flows) (the loader's append-only feed) already bounds
        # the sequence; no N_FRAMES term (it is NaN before the loader runs)
        hi = min(self.fid_cur + 2 * self.voldor_winsize, len(self.flows))
        for f in range(self.fid_cur + 1, hi):
            if f not in self._flow_dev_cache:
                flow = np.asarray(self.flows[f], np.float32)
                if self._flow_transfer_f16:
                    flow = flow.astype(np.float16)
                t = torch.from_numpy(flow)
                if self.device.type == "cuda":
                    t = t.pin_memory().to(self.device, non_blocking=True)
                self._flow_dev_cache[f] = t

    def _vo_dispatch(self, inputs):
        return voldor_dispatch(
            flows=inputs["flows"],
            fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy,
            basefocal=self.basefocal,
            disparity=inputs["disparity"],
            depth_priors=inputs["depth_priors"],
            depth_prior_pconfs=inputs["depth_prior_pconfs"],
            depth_prior_poses=inputs["depth_prior_poses"],
            config=self.voldor_config + " " + self.voldor_user_config
            + (" --save_everything" if self.debug_dir else ""),
            pad_window_to=self.voldor_winsize,
            poses_init=inputs["poses_init"],
            covis_spec=inputs["covis_spec"],
            # dense host copies are deferred to keyframe windows
            # (process_vo calls start_host_copies at the kf decision);
            # mono-scaled fits on the host every window, debug dumps need
            # every map
            host_copies=(self.mode == "mono-scaled") or bool(self.debug_dir),
            device=self.device,
        )

    def process_vo(self):
        """(voldor_slam.py:416-536; system.py:694-881) — pipelined across
        calls: the NEXT window is dispatched at the END of each call.
        Window stepping decisions come from the on-device covisibility
        scores read with the poses. A map write-back between calls bumps
        _map_version and invalidates the in-flight window: it is discarded
        and re-dispatched against the rebased map.

        While the metrics logger is open, each call is traced
        (``utils/profiling.py``): its spans, reads of the device and counts
        join the call's ``vo_window`` event."""
        t0 = time.perf_counter()
        if not self.metrics.enabled:
            return self._process_vo(t0)
        profiling.open_record("vo.call")
        try:
            return self._process_vo(t0)
        finally:
            profiling.close_record()  # a call that logged no vo_window

    def _process_vo(self, t0):
        win_log = None
        dispatched_fid = None
        kf_append = None
        with self._map_lock.r_locked():
            if self.fid_cur >= (self.N_FRAMES - 1):
                self._vo_pending = None
                self.frames.append(Frame(np.linalg.inv(self.Twc_cur)))
                self.fid_cur = int(self.N_FRAMES)
                return False

            prev_prior_fids = {self.fid_cur_tmpkf, self.fid_cur_spakf}
            pend = self._vo_pending
            self._vo_pending = None
            if (
                pend is not None
                and pend["fid"] == self.fid_cur
                and pend["map_version"] == self._map_version
            ):
                handle, inputs = pend["handle"], pend["inputs"]
            else:
                if pend is not None:
                    self.metrics.log("vo_pipeline_flush", fid=int(self.fid_cur))
                with profiling.span("vo.inputs"):
                    inputs = self._vo_window_inputs()
                with profiling.span("vo.dispatch"):
                    handle = self._vo_dispatch(inputs)
                dispatched_fid = inputs["fid"]
                with profiling.span("vo.upload"):
                    self._flow_upload_ahead()
            with profiling.span("vo.collect"):
                vo_ret = handle.collect()

            if self.debug_dir:
                from voldor_tpu_torch.utils.debug_viz import dump_window_debug

                dbg = dict(vo_ret)
                dbg["depth"] = handle.depth_host()
                dbg["depth_conf"] = handle.conf_host()
                dump_window_debug(self.debug_dir, int(self.fid_cur), dbg)

            if vo_ret["n_registered"] == 0:
                print(f"Tracking lost at {self.fid_cur}")
                self.metrics.log("tracking_lost", fid=int(self.fid_cur))
                self.frames.append(Frame(np.linalg.inv(self.Twc_cur)))
                self.edges.append(
                    Edge(self.fid_cur, self.fid_cur + 1, pose=Edge.pose_static,
                         pose_covar=Edge.pose_covar_null, edge_type="none")
                )
                self.fid_cur_tmpkf = -1
                self.fid_cur_spakf = -1
                self.fid_cur += 1
            else:
                if self.mode == "mono-scaled":
                    if not self.disp_loader_sync(self.fid_cur):
                        raise RuntimeError("Disparity loader not working or files are missing.")
                    # the window's maps on the host: the Huber disparity fit
                    # rescales them in place (this window's frame then keeps
                    # host maps; the covis gates are scale-invariant since
                    # the fit rescales depth and translations jointly)
                    with profiling.span("vo.scale_fit"):
                        with profiling.span("vo.scale_copy"):
                            vo_ret["depth"] = handle.depth_host()
                            vo_ret["depth_conf"] = handle.conf_host()
                        profiling.count("scale_fit_bytes",
                                        vo_ret["depth"].nbytes + vo_ret["depth_conf"].nbytes)
                        self._mono_scaled_fit(vo_ret)

                Tc1c2 = T6_to_T44(vo_ret["poses"])

                # window stepping from the on-device covisibility scores
                # (the reference's host eval_covisibility loop,
                # voldor_slam.py:449-458)
                vo_step = 0
                for i in range(vo_ret["n_registered"]):
                    vo_step += 1
                    if vo_ret["covis"][i] < self.vostep_visibility_thresh:
                        break

                for i in range(vo_step):
                    if i == 0:
                        f0 = Frame(np.linalg.inv(self.Twc_cur))
                        if "depth" in vo_ret:  # mono-scaled host maps
                            f0.depth = vo_ret["depth"]
                            f0.depth_conf = vo_ret["depth_conf"]
                        else:
                            f0.set_window_maps(handle.depth_dev, handle.conf_dev)
                        self.frames.append(f0)
                    else:
                        self.frames.append(Frame(np.linalg.inv(self.Twc_cur)))
                    tmpkf_scale = (
                        self.frames[self.fid_cur_tmpkf].scale
                        if self.fid_cur_tmpkf >= 0
                        else 1.0
                    )
                    self.edges.append(
                        Edge(self.fid_cur + i, self.fid_cur + i + 1,
                             pose=vo_ret["poses"][i], pose_covar=vo_ret["poses_covar"][i],
                             pose_eval_time_scale=tmpkf_scale, edge_type="vo")
                    )
                    self.Twc_cur = (Tc1c2[i] @ self.Twc_cur).astype(np.float32)
                    polish_T44(self.Twc_cur)

                if self.fid_cur_spakf >= 0:
                    # spakf retention gate at the step actually taken
                    if (
                        vo_ret["spakf_covis"][vo_step - 1]
                        < self.spakf_visibility_thresh
                    ):
                        kf_append = self.fid_cur
                        self.fid_cur_spakf = self.fid_cur
                else:
                    kf_append = self.fid_cur
                    self.fid_cur_spakf = self.fid_cur
                if kf_append is not None:
                    # this window's frame 0 becomes a keyframe: start the
                    # deferred dense copies to the host now
                    handle.start_host_copies()

                if self.metrics.enabled:
                    win_log = dict(
                        fid=int(self.fid_cur),
                        n_registered=int(vo_ret["n_registered"]),
                        vo_step=int(vo_step),
                        n_priors=(
                            len(inputs["depth_priors"])
                            if inputs["depth_priors"] is not None else 0
                        ),
                        _frame=self.frames[self.fid_cur],
                    )
                self.fid_cur_tmpkf = self.fid_cur
                self.fid_cur += vo_step

            # ---- pipeline: dispatch the NEXT window before returning. The
            # pending record is validated against fid/map_version at the
            # next call (map write-backs invalidate it).
            if self.vo_pipeline and self.fid_cur < (self.N_FRAMES - 1):
                with profiling.span("vo.inputs"):
                    nxt = self._vo_window_inputs()
                with profiling.span("vo.dispatch"):
                    nxt_handle = self._vo_dispatch(nxt)
                dispatched_fid = nxt["fid"]
                self._vo_pending = dict(
                    fid=int(self.fid_cur),
                    map_version=self._map_version,
                    handle=nxt_handle,
                    inputs=nxt,
                )
                with profiling.span("vo.upload"):
                    self._flow_upload_ahead()

            # frames that stopped being prior keyframes drop their device
            # tensors (keyframes copy their maps to the host first); this
            # bounds device memory to the two active prior frames
            for pid in prev_prior_fids - {self.fid_cur_tmpkf, self.fid_cur_spakf}:
                if pid >= 0:
                    self.frames[pid].release_device()

            if kf_append is not None:
                self.append_kf(kf_append)

            if win_log is not None:
                # the call's record ends where window_s is read; the
                # logger's own read of the confidence map comes after it
                window_s = time.perf_counter() - t0
                trace = profiling.close_record()
                f0 = win_log.pop("_frame")
                # only when host maps exist or were enqueued (keyframe
                # windows); -1 marks 'not materialized'
                conf_avail = (f0._depth_conf is not None
                              or (f0.is_keyframe and f0.conf_dev is not None))
                self.metrics.log(
                    "vo_window",
                    window_s=round(window_s, 4),
                    mean_depth_conf=(
                        float(np.mean(f0.depth_conf)) if conf_avail else -1.0
                    ),
                    dispatched_fid=dispatched_fid,
                    **win_log,
                    **(trace or {}),
                )
        return True

    def _mono_scaled_fit(self, vo_ret):
        """Huber regression of observed vs predicted disparity
        (voldor_slam.py:472-492; system.py:883-910), with scikit-learn's
        HuberRegressor objective (slam/huber.py). Confident pixels with a
        disparity measurement (> 1e-6, as the JAX package masks holes), at
        most depth_scaling_max_pixels of them drawn by draw_scale_subsample;
        the scale 1 / coef, clipped to [0.1, 10], multiplies the window's
        depth and translations (and their covariances). Counts the pixels
        given to the fit (``scale_fit_px``) and its L-BFGS-B iterations
        (``scale_fit_iters``) in the tracer's record."""
        disp = self.disps[self.fid_cur]
        mask = (vo_ret["depth_conf"] > self.depth_scaling_conf_thresh) & (disp > 1e-6)
        src = self.basefocal / vo_ret["depth"][mask]
        dst = disp[mask]
        if src.size > self.depth_scaling_max_pixels:
            idx = draw_scale_subsample(self.depth_scaling_rng, src.size,
                                       self.depth_scaling_max_pixels)
            src, dst = src[idx], dst[idx]
        profiling.count("scale_fit_px", int(src.size))
        if src.size < 10:
            return
        coef, iters = huber_fit(src, dst)
        profiling.count("scale_fit_iters", iters)
        scale = float(np.clip(1.0 / coef, 0.1, 10))
        vo_ret["depth"] *= scale
        vo_ret["poses"][:, 3:6] *= scale
        vo_ret["poses_covar"][:, :, 3:6] *= scale
        vo_ret["poses_covar"][:, 3:6, :] *= scale

    # ------------------------------------------------------------------
    def append_kf(self, fid):
        """(voldor_slam.py:678-701; system.py:1120-1152) With loop closure
        on: the keyframe's ORB features, the retrieval query (cold-start
        geometry bar until the vocabulary trains), the keyframe-distance
        and geometry gates, lc_candidates, then the keyframe joins the
        retriever. All on the host, in the VO thread.

        Unlike the JAX package, the keyframe is published to kf_ids after
        its loop-closure query, not before: the mapping thread then always
        merges a keyframe's candidates when it registers that keyframe. In
        the JAX package a candidate that lands after the registration finds
        its pair already linked (the idle pass links every pair above
        mp_no_link_thresh as a local link), so whether a revisit becomes a
        loop-closure link depends on thread timing."""
        self.frames[fid].is_keyframe = True
        if self._use_loop_closure:
            with profiling.span("lc.query"):
                self._loop_closure_query(fid, len(self.kf_ids))
        self.kf_ids.append(fid)

    def _loop_closure_query(self, fid, kf_ord):
        """append_kf's loop-closure work for keyframe fid, ordinal kf_ord."""
        import cv2

        if not self.image_loader_sync(fid):
            raise RuntimeError("Image loader not working or files are missing.")
        img = self.images_bgri[fid]
        kps, des = self.feature_detector.detectAndCompute(img, None)
        self.frames[fid].kps = kps
        self.frames[fid].des = des
        gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        # cold-start schedule: same retrieval bar, stricter geometry bar
        # until the vocabulary trains (system.py:112-126)
        geo_thresh = (self.lc_geo_inlier_thresh if getattr(self.retriever, "trained", True)
                      else self.lc_geo_inlier_cold_thresh)
        for rid, score in self.retriever.query_frame(gray, des):
            if score > self.lc_bow_score_thresh:
                if kf_ord + 1 - rid < self.lc_min_kf_distance:
                    continue
                other = self.frames[self.kf_ids[rid]]
                if des is None or other.des is None:
                    continue
                inlier_rate = geometry_check(kps, des, other.kps, other.des)
                if inlier_rate > geo_thresh:
                    self.lc_candidates.append((rid, kf_ord))
        self.retriever.add_frame(gray, des)

    def vo_thread(self):
        """(voldor_slam.py:708-727)"""
        print("VO thread started")
        print(f"VO mode = {self.mode}")
        self.end_of_vo = False
        try:
            while self.process_vo():
                self._viewer_signal_map_changed = True
                while self._block_vo_signal:
                    time.sleep(0.01)
        finally:
            # also when process_vo raises: the mapping thread then flushes
            # and ends instead of waiting for frames that never come (the
            # JAX package sets it only on a normal return)
            self.end_of_vo = True
        print("VO thread ended.")
        print(f"{len(self.kf_ids)} keyframes registered.")

    def mapping_thread(self):
        """(voldor_slam.py:729-828; system.py:1267-1442) The priority-matrix
        scheduler: on each keyframe registration, temporal/spatial link
        priorities over the recent keyframes; links above the realtime
        threshold are queued and dispatched as one falign batch when
        mp_link_batch_min are pending, when they are mp_link_max_delay_s
        old, when a PGO is due, or at the end; a windowed PGO every
        pgo_refine_kf_interval keyframes that brought new links, a global
        one at the end. Loop-closure candidates (append_kf's, with loop
        closure on) are linked at once, and the next PGO after an LC link is
        global.

        While the metrics logger is open, each pass of the thread is traced
        (``utils/profiling.py``, a record of its own on this thread) and
        logged as a ``map_pass`` event: a keyframe registration
        (``map.register``, counting ``map_backlog_kf``, the keyframes
        published and not yet registered), a link batch (``map.links`` >
        ``falign.setup``, ``falign.lm`` a chunk, ``falign.finish``;
        ``falign_pairs``, ``falign_chunks``, ``lc_links``) or a PGO
        (``pgo.solve`` > ``pgo.snapshot``, ``pgo.lm``, ``pgo.apply``;
        ``pgo_poses``, ``pgo_edges``, ``pgo_iters``)."""
        print("Mapping thread started")
        self._mapping_loop()
        print("Mapping thread end.")

    @contextlib.contextmanager
    def _map_pass(self, root):
        """One pass of the mapping thread, traced under ``root`` while the
        metrics logger is open, and logged as a ``map_pass`` event."""
        if not self.metrics.enabled or profiling.recording():
            yield
            return
        profiling.open_record(root)
        try:
            yield
        finally:
            self.metrics.log("map_pass", kind=root, **profiling.close_record())

    def _mapping_loop(self):
        n_kfs_registered = 0
        next_pgo_kfid = self.pgo_refine_kf_interval
        # indexed by keyframe ordinals, grown geometrically
        kf_cap = 256
        link_mask = np.zeros((kf_cap, kf_cap), bool)
        priority_mat = np.zeros((kf_cap, kf_cap), np.float32)

        def _ensure_capacity(n):
            nonlocal kf_cap, link_mask, priority_mat
            if n <= kf_cap:
                return
            while kf_cap < n:
                kf_cap *= 2
            lm = np.zeros((kf_cap, kf_cap), bool)
            pm = np.zeros((kf_cap, kf_cap), np.float32)
            lm[: link_mask.shape[0], : link_mask.shape[1]] = link_mask
            pm[: priority_mat.shape[0], : priority_mat.shape[1]] = priority_mat
            link_mask, priority_mat = lm, pm

        lc_pairs = set()
        new_local_link_flag = False
        new_lc_link_flag = False
        n_lc_seen = 0

        def _merge_lc_candidates(n_kfs_cur):
            # also called from the idle branch: a candidate found by the last
            # keyframe may land after its registration pass (system.py:1301)
            nonlocal n_lc_seen
            updated = False
            for f1, f2 in self.lc_candidates[:]:
                for ff1, ff2 in [(f1, f2), (f1 + 1, f2), (f1 - 1, f2), (f1, f2 + 1), (f1, f2 - 1)]:
                    if 0 <= ff1 < n_kfs_cur and 0 <= ff2 < n_kfs_cur:
                        pri = np.exp(-((abs(ff1 - f1) + abs(ff2 - f2)) / self.mp_lc_sigma) ** 2)
                        if not link_mask[ff1, ff2] and pri > priority_mat[ff1, ff2]:
                            priority_mat[ff1, ff2] = pri
                            updated = True
                        lc_pairs.add((ff1, ff2))
            n_lc_seen = len(self.lc_candidates)
            return updated

        # local links coalesce across registrations (system.py:1327-1336)
        pending_local: list = []
        pending_since = [0.0]

        def _process_pending(thresh, flush=False):
            nonlocal new_local_link_flag, new_lc_link_flag
            Iy, Ix = np.where((priority_mat > thresh) & ~link_mask)
            lc_pair_list = []
            for y, x in zip(Iy, Ix):
                pair = (self.kf_ids[y], self.kf_ids[x])
                if (int(y), int(x)) in lc_pairs:
                    lc_pair_list.append(pair)
                else:
                    if not pending_local:
                        pending_since[0] = time.perf_counter()
                    pending_local.append(pair)
                link_mask[y, x] = True
                priority_mat[y, x] = 0
            ran = False
            if lc_pair_list:
                self.establish_links_batch(lc_pair_list, kind="lc")
                new_lc_link_flag = True
                ran = True
            aged = (pending_local
                    and time.perf_counter() - pending_since[0] > self.mp_link_max_delay_s)
            if pending_local and (flush or aged or len(pending_local) >= self.mp_link_batch_min):
                self.establish_links_batch(pending_local, kind="local")
                pending_local.clear()
                new_local_link_flag = True
                ran = True
            return ran

        while not self.end_of_vo or n_kfs_registered < len(self.kf_ids):
            n_kfs_cur = len(self.kf_ids)
            if n_kfs_cur == 0:
                time.sleep(0.01)
                continue
            _ensure_capacity(n_kfs_cur)

            if n_kfs_registered == n_kfs_cur:
                if n_lc_seen < len(self.lc_candidates):
                    _merge_lc_candidates(n_kfs_cur)
                if not _process_pending(self.mp_no_link_thresh, flush=self.end_of_vo):
                    time.sleep(0.01)
            else:
                # VO blocks only for the registration bookkeeping; the link
                # solves and the PGO run with VO live
                self._block_vo_signal = True
                with self._map_pass("map.register"):
                    profiling.count("map_backlog_kf", n_kfs_cur - n_kfs_registered)
                    priority_mat[...] = 0

                    if not self.disable_local_mapping:
                        for f1 in range(max(0, n_kfs_cur - 2 * self.mp_temporal_sigma), n_kfs_cur):
                            for f2 in range(f1 + 1, min(n_kfs_cur, f1 + 2 * self.mp_spatial_sigma)):
                                priority_mat[f1, f2] = max(
                                    priority_mat[f1, f2],
                                    np.exp(
                                        -((f1 - f2) / self.mp_spatial_sigma) ** 2
                                        - ((n_kfs_cur - f1) * (n_kfs_cur - f2)
                                           / self.mp_temporal_sigma**2)
                                    ),
                                )

                    _merge_lc_candidates(n_kfs_cur)

                    priority_mat[link_mask] = 0
                    n_kfs_registered = n_kfs_cur
                self._block_vo_signal = False

                pgo_due = n_kfs_cur >= next_pgo_kfid
                _process_pending(self.mp_realtime_link_thresh, flush=pgo_due)

                if pgo_due and (new_local_link_flag or new_lc_link_flag):
                    if new_lc_link_flag:
                        self.solve_pgo()
                    else:
                        self.solve_pgo(self.kf_ids[
                            0 if self.pgo_local_kf_winsize > n_kfs_cur
                            else -self.pgo_local_kf_winsize])
                    self._viewer_signal_map_changed = True
                    new_local_link_flag = False
                    new_lc_link_flag = False
                    next_pgo_kfid = n_kfs_cur + self.pgo_refine_kf_interval

        # drain the remaining above-threshold links before the final global
        # PGO (system.py:1432-1438)
        _merge_lc_candidates(len(self.kf_ids))
        _process_pending(self.mp_no_link_thresh, flush=True)

        self.solve_pgo()
        self._viewer_signal_map_changed = True


def _quat_xyzw_from_R(R):
    rvec = R_to_rvec(R)
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.asarray([0.0, 0.0, 0.0, 1.0])
    axis = rvec / theta
    return np.asarray(
        [*(axis * np.sin(theta / 2)), np.cos(theta / 2)]
    )
