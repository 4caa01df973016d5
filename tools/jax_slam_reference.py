"""The JAX package's full-SLAM pass with loop closure off: the reference the
port's slam-full-mono phase (chip_smoke.py) is held to.

    JAX_PLATFORMS=cpu python tools/jax_slam_reference.py [--out FILE]

The scene is bench.py's build_slam_scene(60) (613x185, 60 flows, out and
back, textured gray images), configured as bench.py:_make_slam_e2e except
that enable_loop_closure is not called; the falign/PGO compile warm-up
thread is off (it only pre-compiles, and changes no result). vo_thread and
mapping_thread run as two threads, joined with a timeout as in
bench.py:_run_slam_once. Prints one JSON record: the Sim3 ATE against the
scene's ground truth and its gate (0.02 x extent), keyframes, edges by
type, link decisions and the PGO solves.
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the record to this file")
    ap.add_argument("--timeout", type=float, default=7200.0)
    args = ap.parse_args()

    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import bench
    from voldor_tpu.slam.system import VOLDOR_SLAM
    from voldor_tpu.utils.evaluation import ate_rmse

    flows, _, images_grayf, Ts = bench.build_slam_scene(60)
    slam = VOLDOR_SLAM(mode="mono")
    slam.aot_warmup = False
    slam.set_cam_params(350.0, 350.0, bench.W / 2, bench.H / 2)
    slam.flows = [flows[i] for i in range(flows.shape[0])]
    slam.N_FRAMES = flows.shape[0] + 1
    slam.h, slam.w = bench.H, bench.W
    slam.flow_loader_pt = flows.shape[0]
    slam.images_grayf = list(images_grayf)
    slam.image_loader_pt = len(images_grayf)
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
    rec = dict(
        what="JAX package full-SLAM pass, loop closure off, on the CPU",
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
