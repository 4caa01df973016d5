"""The JAX package's full-SLAM pass: the reference the port's
slam-full-mono phase (chip_smoke.py) is held to.

    JAX_PLATFORMS=cpu python tools/jax_slam_reference.py [--loop_closure] [--out FILE]

The scene is bench.py's build_slam_scene(60) (613x185, 60 flows, out and
back, textured gray images), configured as bench.py:_make_slam_e2e; without
--loop_closure, enable_loop_closure is not called. The falign/PGO compile
warm-up thread is off (it only pre-compiles, and changes no result).
vo_thread and mapping_thread run as two threads, joined with a timeout as in
bench.py:_run_slam_once. Prints one JSON record: the Sim3 ATE against the
scene's ground truth and its gate (0.02 x extent), keyframes, edges by
type, link decisions (local and loop-closure), the loop-closure candidates,
the PGO solves and cv2's version.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kf_after_query(cls):
    """cls with append_kf publishing the keyframe after its loop-closure
    query. The JAX package's append_kf runs unchanged, but the thread
    calling it sees kf_ids through a private copy that already holds the
    keyframe; every other thread sees the shared list, which gets the
    keyframe when the call returns."""

    class KfAfterQuery(cls):
        _local = threading.local()

        @property
        def kf_ids(self):
            staged = getattr(self._local, "staged", None)
            return self._kf_ids if staged is None else staged

        @kf_ids.setter
        def kf_ids(self, value):
            self._kf_ids = value

        def append_kf(self, fid):
            self._local.staged = list(self._kf_ids)
            try:
                super().append_kf(fid)
            finally:
                self._local.staged = None
            self._kf_ids.append(fid)

    return KfAfterQuery


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the record to this file")
    ap.add_argument("--timeout", type=float, default=7200.0)
    ap.add_argument("--loop_closure", action="store_true",
                    help="call enable_loop_closure() with the built-in vocabulary, as the bench does")
    ap.add_argument("--kf_after_query", action="store_true",
                    help="publish each keyframe to kf_ids after its loop-closure query, as the "
                         "port's append_kf does (the JAX package publishes it before)")
    args = ap.parse_args()

    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import bench
    from voldor_tpu.slam.system import VOLDOR_SLAM
    from voldor_tpu.utils.evaluation import ate_rmse

    flows, images_bgri, images_grayf, Ts = bench.build_slam_scene(60)
    slam = (_kf_after_query(VOLDOR_SLAM) if args.kf_after_query else VOLDOR_SLAM)(mode="mono")
    slam.aot_warmup = False
    slam.set_cam_params(350.0, 350.0, bench.W / 2, bench.H / 2)
    slam.flows = [flows[i] for i in range(flows.shape[0])]
    slam.N_FRAMES = flows.shape[0] + 1
    slam.h, slam.w = bench.H, bench.W
    slam.flow_loader_pt = flows.shape[0]
    slam.images_bgri = list(images_bgri)
    slam.images_grayf = list(images_grayf)
    slam.image_loader_pt = len(images_grayf)
    if args.loop_closure:
        slam.enable_loop_closure()
    slam.lc_min_kf_distance = 3
    events = []
    slam.metrics.log = lambda event, **kw: events.append(dict(event=event, **kw))

    t0 = time.perf_counter()
    vo = threading.Thread(target=slam.vo_thread, daemon=True)
    mp = threading.Thread(target=slam.mapping_thread, daemon=True)
    vo.start()
    mp.start()
    vo.join(timeout=args.timeout)
    mp.join(timeout=args.timeout)
    dt = time.perf_counter() - t0

    gt = np.linalg.inv(Ts)
    extent = float(np.linalg.norm(gt[:, :3, 3] - gt[0, :3, 3], axis=1).max())
    est = np.stack([f.Tcw for f in slam.frames]).astype(np.float64)
    ate = ate_rmse(est, gt, with_scale=True)
    links = [e for e in events if e["event"] == "local_link"]
    lc_links = [e for e in events if e["event"] == "lc_link"]
    import cv2

    rec = dict(
        what=f"JAX package full-SLAM pass, loop closure {'on' if args.loop_closure else 'off'}, "
             "on the CPU",
        cv2_version=cv2.__version__,
        jax_backend=jax.default_backend(),
        threads_alive=vo.is_alive() or mp.is_alive(),
        wall_s=dt,
        n_frames=len(slam.frames),
        keyframes=list(slam.kf_ids),
        edges={t: sum(1 for e in slam.edges if e.edge_type == t)
               for t in sorted({e.edge_type for e in slam.edges})},
        local_links_tried=len(links),
        local_links_accepted=sum(1 for e in links if e["accepted"]),
        links=links,
        lc_candidates=[[int(a), int(b)] for a, b in slam.lc_candidates],
        lc_links=lc_links,
        pgo=[e for e in events if e["event"] == "pgo"],
        ate=ate,
        extent=extent,
        gate=0.02 * extent,
        passes_gate=bool(ate < 0.02 * extent),
    )
    line = json.dumps(rec, default=float)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
