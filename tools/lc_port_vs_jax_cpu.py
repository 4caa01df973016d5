#!/usr/bin/env python3
"""The port's full-SLAM pass with loop closure beside the JAX package's, both
on the CPU, on the same scene.

    JAX_PLATFORMS=cpu python tools/lc_port_vs_jax_cpu.py [--record DIR] [--out FILE]

The scene is chip_smoke.py's build_slam_scene(60) (bench.py:240-298: 613x185,
60 flows out and back with a revisit, textured gray images), rendered once
and handed to both packages. Each side is configured as
bench.py:_make_slam_e2e (chip_smoke.make_full_slam for the port, with
device="cpu"), with enable_loop_closure(); the JAX side publishes each
keyframe after its loop-closure query (tools/jax_slam_reference.py
--kf_after_query), as the port's append_kf does. The two sides run as two
child processes at once (``--side port`` / ``--side jax``), vo_thread and
mapping_thread as two threads in each.

Prints, side by side: the keyframes, the loop-closure candidates, each LC
link's consistency and visibility, the edges by type, the Sim3 ATE against
the scene's ground truth, and each keyframe's position after the final PGO.
With --record DIR, each side also writes the inputs and results of its
loop-closure falign_pairs calls (DIR/{port,jax}_lc_calls.pkl) and its
keyframes' depth maps and final poses (DIR/{port,jax}_keyframes.npz);
``--cross DIR`` then solves each recorded pass's loop-closure inputs
(DIR/*_lc_calls.pkl, also those tools/lc_links_card_vs_cpu.py records on
the card) with both packages' falign_pairs, which tells a difference of the
VO maps from a difference of the alignment.

    JAX_PLATFORMS=cpu python tools/lc_port_vs_jax_cpu.py --cli DIR

runs the demo CLI of each package on the CPU on the same files instead:
the full-SLAM scene rendered at KITTI's 1226x370 (fx = fy = 700, as
chip_smoke.py's phase 16 writes it) as .flo and PNG files in DIR, through
`demo/demo.py` and `python -m voldor_tpu_torch.demo --device cpu`, both with
--enable_mapping --enable_loop_closure and the default --resize 0.5. Prints
each keyframe's retrieval results (earlier keyframe, BoW score) and, for
every pair of keyframes, the geometry check's inlier rate on the ORB
features each run computed (cv2's RANSAC seeded per pair), beside the
thresholds and the loop-closure candidates each run made.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))  # synthetic.py renders the scene
sys.path.insert(0, str(ROOT / "tools"))

N_FLOWS = 60


def scene(which="port"):
    """The full-SLAM scene as chip_smoke.py renders it (the port's so3_exp)
    or as bench.py does (the JAX package's): the two differ in the last bits
    of the poses, hence in the flows and in texture edges."""
    import numpy as np
    import torch

    import chip_smoke as cs

    sc = cs.build_slam_scene(np, torch, N_FLOWS)
    if which == "bench":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import bench

        flows, images_bgri, images_grayf, Ts = bench.build_slam_scene(N_FLOWS)
        sc.update(flows=flows, images_bgri=list(images_bgri), images_grayf=list(images_grayf),
                  Ts=np.asarray(Ts))
    return sc


def make_jax_slam(sc, loop_closure=True):
    """The JAX package's VOLDOR_SLAM as tools/jax_slam_reference.py makes it
    (--loop_closure --kf_after_query), on the port's rendering of the scene."""
    import chip_smoke as cs
    from jax_slam_reference import _kf_after_query
    from voldor_tpu.slam.system import VOLDOR_SLAM

    slam = _kf_after_query(VOLDOR_SLAM)(mode="mono")
    slam.aot_warmup = False
    slam.set_cam_params(cs.FX, cs.FY, cs.W / 2, cs.H / 2)
    flows = sc["flows"]
    slam.flows = [flows[i] for i in range(flows.shape[0])]
    slam.N_FRAMES = flows.shape[0] + 1
    slam.h, slam.w = cs.H, cs.W
    slam.flow_loader_pt = flows.shape[0]
    slam.images_bgri = list(sc["images_bgri"])
    slam.images_grayf = list(sc["images_grayf"])
    slam.image_loader_pt = len(sc["images_grayf"])
    if loop_closure:
        slam.enable_loop_closure()
    slam.lc_min_kf_distance = 3
    return slam


def _recording(module, calls):
    """Wrap module.falign_pairs: keep the loop-closure calls (stride 3, the
    SLAM layer's falign_lc_link_stride in both packages)."""
    import numpy as np

    real = module.falign_pairs

    def rec(**kw):
        out = real(**kw)
        if kw.get("stride") == 3:
            keep = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
                    for k, v in kw.items() if k != "device"}
            calls.append((keep, [{k: np.asarray(v) for k, v in r.items()} for r in out]))
        return out

    module.falign_pairs = rec
    return real


def run_side(side, record, which="port", loop_closure=True):
    """One pass of vo_thread + mapping_thread on the CPU; returns its record."""
    import numpy as np
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    sc = scene(which)
    calls = []
    if side == "port":
        import chip_smoke as cs
        import voldor_tpu_torch  # noqa: F401
        from voldor_tpu_torch.falign import api as falign_api
        from voldor_tpu_torch.utils.evaluation import ate_rmse

        slam = cs.make_full_slam(sc, loop_closure, device="cpu")
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        from voldor_tpu.falign import api as falign_api
        from voldor_tpu.utils.evaluation import ate_rmse

        slam = make_jax_slam(sc, loop_closure)
    real = _recording(falign_api, calls) if record else None
    events = []
    slam.metrics.log = lambda event, **kw: events.append(dict(event=event, **kw))
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=slam.vo_thread, daemon=True),
                   threading.Thread(target=slam.mapping_thread, daemon=True)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=7200)
    finally:
        if real is not None:
            falign_api.falign_pairs = real
    wall = time.perf_counter() - t0
    gt = np.linalg.inv(sc["Ts"])
    extent = float(np.linalg.norm(gt[:, :3, 3] - gt[0, :3, 3], axis=1).max())
    est = np.stack([f.Tcw for f in slam.frames]).astype(np.float64)
    kfs = [int(k) for k in slam.kf_ids]
    rec = dict(
        side=side,
        wall_s=wall,
        alive=any(t.is_alive() for t in threads),
        keyframes=kfs,
        lc_candidates=[[int(a), int(b)] for a, b in slam.lc_candidates],
        lc_links=[dict(kf_ids=[int(k) for k in e["kf_ids"]], consistency=float(e["consistency"]),
                       visibility=float(e["visibility"]), accepted=bool(e["accepted"]))
                  for e in events if e["event"] == "lc_link"],
        local_links=[dict(kf_ids=[int(k) for k in e["kf_ids"]], consistency=float(e["consistency"]),
                          visibility=float(e["visibility"]), accepted=bool(e["accepted"]))
                     for e in events if e["event"] == "local_link"],
        edges={t: sum(1 for e in slam.edges if e.edge_type == t)
               for t in sorted({e.edge_type for e in slam.edges})},
        ate=float(ate_rmse(est, gt, with_scale=True)),
        gate=0.02 * extent,
        kf_positions={k: np.linalg.inv(slam.frames[k].Tcw)[:3, 3].tolist() for k in kfs},
    )
    if record:
        Path(record).mkdir(parents=True, exist_ok=True)
        with open(Path(record) / f"{side}_lc_calls.pkl", "wb") as f:
            pickle.dump(calls, f)
        maps = {}
        for k in kfs:
            maps[f"depth_{k}"] = np.asarray(slam.frames[k].depth, np.float32)
            maps[f"Tcw_{k}"] = np.asarray(slam.frames[k].Tcw)
        np.savez(Path(record) / f"{side}_keyframes.npz", **maps)
    return rec


CLI_H, CLI_W, CLI_F = 370, 1226, 700.0  # chip_smoke.py's phase 16


def write_cli_files(d):
    """The phase-16 files: 60 .flo flows and 61 PNG images at 1226x370."""
    import cv2
    import numpy as np
    import torch

    import chip_smoke as cs
    from voldor_tpu_torch.utils.flow_io import save_flow

    d = Path(d)
    if (d / "image" / f"{N_FLOWS:06d}.png").exists():
        return
    sc = cs.build_slam_scene(np, torch, N_FLOWS, h=CLI_H, w=CLI_W, focal=CLI_F)
    (d / "flow").mkdir(parents=True, exist_ok=True)
    (d / "image").mkdir(parents=True, exist_ok=True)
    for i, fl in enumerate(sc["flows"]):
        save_flow(str(d / "flow" / f"{i:06d}.flo"), fl)
    for i, im in enumerate(sc["images_bgri"]):
        cv2.imwrite(str(d / "image" / f"{i:06d}.png"), im)


def run_cli_side(side, d):
    """One package's demo CLI on the files in d, with its retriever's
    queries recorded; then the geometry check of every keyframe pair."""
    import runpy

    import cv2
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    if side == "port":
        from voldor_tpu_torch.slam import loop_closure as lc
        from voldor_tpu_torch.slam.slam_utils import geometry_check
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        from voldor_tpu.slam import loop_closure as lc
        from voldor_tpu.slam.slam_utils import geometry_check
    queries = []
    real = lc.BowRetriever.query_frame

    def query_frame(self, *a, **k):
        out = real(self, *a, **k)
        queries.append([(int(r), float(s)) for r, s in out])
        return out

    lc.BowRetriever.query_frame = query_frame
    d = Path(d)
    argv = ["--mode", "mono", "--flow_dir", str(d / "flow"), "--img_dir", str(d / "image"),
            "--fx", str(CLI_F), "--fy", str(CLI_F), "--cx", str(CLI_W / 2), "--cy", str(CLI_H / 2),
            "--enable_mapping", "--enable_loop_closure", "--save_poses", str(d / f"{side}_poses.txt")]
    t0 = time.perf_counter()
    if side == "port":
        from voldor_tpu_torch.demo import main as demo_main

        slam = demo_main(argv + ["--device", "cpu"])
    else:
        sys.argv = [str(ROOT / "demo" / "demo.py"), *argv]
        slam = runpy.run_path(str(ROOT / "demo" / "demo.py"), run_name="__main__")["slam"]
    wall = time.perf_counter() - t0
    kfs = [int(k) for k in slam.kf_ids]
    inliers = {}
    for j in range(len(kfs)):
        for i in range(j):
            a, b = slam.frames[kfs[j]], slam.frames[kfs[i]]
            cv2.setRNGSeed(1000 * j + i)
            inliers[f"{i},{j}"] = (float(geometry_check(a.kps, a.des, b.kps, b.des))
                                   if a.des is not None and b.des is not None else None)
    return dict(side=side, wall_s=wall, keyframes=kfs, queries=queries, inliers=inliers,
                n_features=[0 if slam.frames[k].des is None else len(slam.frames[k].des) for k in kfs],
                lc_candidates=[[int(a), int(b)] for a, b in slam.lc_candidates],
                bow_score_thresh=float(slam.lc_bow_score_thresh),
                geo_inlier_thresh=float(slam.lc_geo_inlier_thresh),
                min_kf_distance=int(slam.lc_min_kf_distance), cv2_version=cv2.__version__)


def compare_cli(port, jax_rec):
    print(f"[cli] wall s: port {port['wall_s']:.1f}, jax {jax_rec['wall_s']:.1f}")
    for key in ("keyframes", "n_features", "lc_candidates", "bow_score_thresh",
                "geo_inlier_thresh", "min_kf_distance"):
        print(f"[cli] {key}: port {port[key]} | jax {jax_rec[key]} | "
              f"{'same' if port[key] == jax_rec[key] else 'DIFFER'}")
    for n in range(max(len(port["queries"]), len(jax_rec["queries"]))):
        p = port["queries"][n] if n < len(port["queries"]) else None
        j = jax_rec["queries"][n] if n < len(jax_rec["queries"]) else None
        print(f"[cli] keyframe {n} retrieval (earlier keyframe, score): port "
              f"{[(r, round(s, 4)) for r, s in p] if p is not None else None} | jax "
              f"{[(r, round(s, 4)) for r, s in j] if j is not None else None}")
    over = {k: (v, jax_rec["inliers"].get(k)) for k, v in port["inliers"].items()
            if max(v or 0.0, jax_rec["inliers"].get(k) or 0.0) > port["geo_inlier_thresh"]}
    print(f"[cli] keyframe pairs whose geometry-check inlier rate passes "
          f"{port['geo_inlier_thresh']} on either side (port, jax): "
          f"{ {k: tuple(None if x is None else round(x, 4) for x in v) for k, v in over.items()} }")
    diff = max((abs(v - jax_rec["inliers"][k]) for k, v in port["inliers"].items()
                if v is not None and jax_rec["inliers"].get(k) is not None), default=0.0)
    print(f"[cli] largest |port - jax| inlier rate over all keyframe pairs: {diff:.4f}", flush=True)


def _score(np, out):
    return [(round(float(np.nanmean(r["consistency_mat"])), 4),
             round(float(np.nanmean(r["visibility_mat"])), 4)) for r in out]


def cross(record):
    """Every recorded pass's loop-closure calls (record/NAME_lc_calls.pkl:
    this tool's port and jax sides, tools/lc_links_card_vs_cpu.py's card
    and cpu passes) solved by both packages' falign_pairs on the CPU: each
    call as recorded, and the two-stage chain from the recorded geometric
    inputs."""
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from voldor_tpu.falign.api import falign_pairs as jfp
    from voldor_tpu_torch.falign.api import falign_pairs as tfp

    solvers = {"port": lambda **kw: tfp(**kw, device="cpu"), "jax": jfp}
    for path in sorted(Path(record).glob("*_lc_calls.pkl")):
        side = path.name[:-len("_lc_calls.pkl")]
        with open(path, "rb") as f:
            calls = pickle.load(f)
        print(f"[cross] {side}'s pass: {len(calls)} loop-closure falign calls", flush=True)
        for i, (kw, out) in enumerate(calls):
            stage = "photo" if kw.get("images") is not None else "geo"
            print(f"  call {i} ({stage}), in the pass {_score(np, out)}; solved by "
                  + ", ".join(f"{n} {_score(np, s(**kw))}" for n, s in solvers.items()), flush=True)
        geo = [c[0] for c in calls if c[0].get("images") is None]
        photo = [c[0] for c in calls if c[0].get("images") is not None]
        for gkw, pkw in zip(geo, photo):
            for n, s in solvers.items():
                g = s(**gkw)
                p = s(**dict(pkw, poses_init=np.stack([r["poses_ret"] for r in g])))
                print(f"  the chain on {side}'s inputs by {n}: geo {_score(np, g)} -> photo "
                      f"{_score(np, p)}", flush=True)


def compare(port, jax_rec):
    print(f"[compare] wall s: port {port['wall_s']:.1f}, jax {jax_rec['wall_s']:.1f}")
    for key in ("keyframes", "lc_candidates", "edges"):
        print(f"[compare] {key}: port {port[key]} | jax {jax_rec[key]} | "
              f"{'same' if port[key] == jax_rec[key] else 'DIFFER'}")
    links = {tuple(e["kf_ids"]): e for e in jax_rec["lc_links"]}
    for e in port["lc_links"]:
        j = links.pop(tuple(e["kf_ids"]), None)
        jtxt = (f"jax {j['consistency']:.4f} / {j['visibility']:.4f} {j['accepted']}" if j
                else "jax: no such link")
        print(f"[compare] LC link {e['kf_ids']}: port {e['consistency']:.4f} / "
              f"{e['visibility']:.4f} {e['accepted']} | {jtxt}")
    for k, j in links.items():
        print(f"[compare] LC link {list(k)}: port: no such link | jax {j['consistency']:.4f} / "
              f"{j['visibility']:.4f} {j['accepted']}")
    print(f"[compare] Sim3 ATE: port {port['ate']:.6f} | jax {jax_rec['ate']:.6f} "
          f"(gate {port['gate']:.6f})")
    common = [k for k in port["kf_positions"] if k in jax_rec["kf_positions"]]
    import numpy as np

    d = {k: float(np.linalg.norm(np.subtract(port["kf_positions"][k], jax_rec["kf_positions"][k])))
         for k in common}
    print(f"[compare] keyframe positions after the final PGO, |port - jax|: "
          f"{ {k: round(v, 5) for k, v in d.items()} }", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", choices=("port", "jax"), default=None,
                    help="run one side in this process and print its record")
    ap.add_argument("--record", default=None,
                    help="directory for each side's loop-closure falign calls and keyframe maps")
    ap.add_argument("--cross", default=None,
                    help="solve the calls recorded in this directory with both packages' falign")
    ap.add_argument("--out", default=None, help="also write both records to this file")
    ap.add_argument("--cli", default=None,
                    help="run both demo CLIs on the phase-16 files in this directory instead")
    ap.add_argument("--cli_side", choices=("port", "jax"), default=None)
    ap.add_argument("--scene", choices=("port", "bench"), default="port",
                    help="the scene's rendering handed to both sides: chip_smoke.py's (default) "
                         "or bench.py's")
    ap.add_argument("--no_loop_closure", action="store_true",
                    help="both passes without enable_loop_closure(), for comparison")
    args = ap.parse_args()
    os.chdir(ROOT)
    if args.cli and args.cli_side:
        print("[side] " + json.dumps(run_cli_side(args.cli_side, args.cli)), flush=True)
        # the demos leave daemon threads (loaders, viewer) behind; the JAX
        # package's abort at interpreter teardown
        os._exit(0)
    if args.cross:
        cross(args.cross)
        return
    if args.side:
        print("[side] " + json.dumps(run_side(args.side, args.record, args.scene,
                                                       not args.no_loop_closure)), flush=True)
        return
    if args.cli:
        write_cli_files(args.cli)
        child = {s: ["--cli", args.cli, "--cli_side", s] for s in ("port", "jax")}
    else:
        extra = ["--record", args.record] if args.record else []
        extra += ["--scene", args.scene] + (["--no_loop_closure"] if args.no_loop_closure else [])
        child = {s: ["--side", s, *extra] for s in ("port", "jax")}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {s: subprocess.Popen([sys.executable, __file__, *a], env=env, stdout=subprocess.PIPE,
                                 text=True)
             for s, a in child.items()}
    recs = {}
    for s, p in procs.items():
        out, _ = p.communicate()
        got = [ln for ln in out.splitlines() if ln.startswith("[side] ")]
        if p.returncode != 0 or not got:
            raise RuntimeError(f"the {s} side exited {p.returncode}:\n{out[-3000:]}")
        recs[s] = json.loads(got[-1][len("[side] "):])
        print(got[-1], flush=True)
    if args.cli:
        compare_cli(recs["port"], recs["jax"])
        return
    compare(recs["port"], recs["jax"])
    if args.out:
        Path(args.out).write_text(json.dumps(recs) + "\n")
    if args.record:
        cross(args.record)


if __name__ == "__main__":
    main()
