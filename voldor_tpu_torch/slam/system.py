"""VOLDOR_SLAM: the SLAM orchestrator of the port, its VO layer so far
(port of ``voldor_tpu/slam/system.py:39-881, 1120-1166``).

Same attributes, thresholds and mode configs as the JAX package's
``VOLDOR_SLAM``, plus a ``device`` keyword: the frame/edge graph,
covisibility-gated VO stepping from on-device scores, temporal and spatial
keyframes, and the pipelined window dispatch (one window in flight across
``process_vo`` calls, invalidated by ``_map_version``).

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): frame alignment links and PGO (``solve_pgo``, ``establish_*``,
``mapping_thread``), loop closure, the file loaders of the demo, and the
``mono-scaled`` mode.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from voldor_tpu_torch.config import VoldorConfig
from voldor_tpu_torch.slam.frame import Edge, Frame
from voldor_tpu_torch.slam.rwlock import RWLock
from voldor_tpu_torch.slam.slam_utils import R_to_rvec, T6_to_T44, T44_to_T6, polish_T44
from voldor_tpu_torch.utils.metrics import MetricsLogger
from voldor_tpu_torch.vo.api import voldor_dispatch
from voldor_tpu_torch.vo.engine import DeviceMap, resolve_device


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP queue A, item {item})")


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
        self.debug_dir = None  # per-window debug dumps: not ported
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
            # the Huber disparity-scale fit (system.py:883) needs scikit-learn
            _not_ported("mode 'mono-scaled'", "3")
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
    # loader sync (voldor_slam.py:207-315). The loaders feed the lists and
    # advance the *_loader_pt counters; callers may also fill them directly.
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
        _not_ported("the flow file loader", "6 (the demo CLI)")

    def image_loader(self, image_path, n_cache=100, range=(0, 0)):
        _not_ported("the image file loader", "6 (the demo CLI)")

    def disp_loader(self, disp_path, n_cache=100, range=(0, 0)):
        _not_ported("the disparity file loader", "6 (the demo CLI)")

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
        _not_ported("loop closure", "6 (full SLAM)")

    def solve_pgo(self, fid_start=0):
        _not_ported("solve_pgo", "5 (pgo/*)")

    def establish_local_links(self, kf_ids):
        _not_ported("frame-alignment links", "4 (falign/*)")

    def establish_links_batch(self, pair_list, kind="local"):
        _not_ported("frame-alignment links", "4 (falign/*)")

    def establish_lc_links(self, kf_ids):
        _not_ported("loop-closure links", "4 (falign/*) and 6 (full SLAM)")

    def mapping_thread(self):
        _not_ported("the mapping thread", "6 (full SLAM)")

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
            config=self.voldor_config + " " + self.voldor_user_config,
            pad_window_to=self.voldor_winsize,
            poses_init=inputs["poses_init"],
            covis_spec=inputs["covis_spec"],
            # dense host copies are deferred to keyframe windows
            # (process_vo calls start_host_copies at the kf decision)
            host_copies=False,
            device=self.device,
        )

    def process_vo(self):
        """(voldor_slam.py:416-536; system.py:694-881) — pipelined across
        calls: the NEXT window is dispatched at the END of each call.
        Window stepping decisions come from the on-device covisibility
        scores read with the poses. A map write-back between calls bumps
        _map_version and invalidates the in-flight window: it is discarded
        and re-dispatched against the rebased map."""
        if self.debug_dir:
            _not_ported("per-window debug dumps (utils/debug_viz.py)", "7")
        _t0 = time.perf_counter()
        win_log = None
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
                inputs = self._vo_window_inputs()
                handle = self._vo_dispatch(inputs)
                self._flow_upload_ahead()
            vo_ret = handle.collect()

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
                nxt = self._vo_window_inputs()
                self._vo_pending = dict(
                    fid=int(self.fid_cur),
                    map_version=self._map_version,
                    handle=self._vo_dispatch(nxt),
                    inputs=nxt,
                )
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
                f0 = win_log.pop("_frame")
                # only when host maps exist or were enqueued (keyframe
                # windows); -1 marks 'not materialized'
                conf_avail = (f0._depth_conf is not None
                              or (f0.is_keyframe and f0.conf_dev is not None))
                self.metrics.log(
                    "vo_window",
                    window_s=round(time.perf_counter() - _t0, 4),
                    mean_depth_conf=(
                        float(np.mean(f0.depth_conf)) if conf_avail else -1.0
                    ),
                    **win_log,
                )
        return True

    # ------------------------------------------------------------------
    def append_kf(self, fid):
        """(voldor_slam.py:678-701), loop closure off."""
        self.frames[fid].is_keyframe = True
        self.kf_ids.append(fid)

    def vo_thread(self):
        """(voldor_slam.py:708-727)"""
        print("VO thread started")
        print(f"VO mode = {self.mode}")
        self.end_of_vo = False
        while self.process_vo():
            self._viewer_signal_map_changed = True
            while self._block_vo_signal:
                time.sleep(0.01)
        self.end_of_vo = True
        print("VO thread ended.")
        print(f"{len(self.kf_ids)} keyframes registered.")


def _quat_xyzw_from_R(R):
    rvec = R_to_rvec(R)
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.asarray([0.0, 0.0, 0.0, 1.0])
    axis = rvec / theta
    return np.asarray(
        [*(axis * np.sin(theta / 2)), np.cos(theta / 2)]
    )
