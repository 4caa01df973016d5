#!/usr/bin/env python3
"""The loop-closure links of the slam-full-mono pass on the card against the
same pass on the CPU, and the keyframe publication order on the card.

    python3 tools/lc_links_card_vs_cpu.py [--out DIR]

Runs chip_smoke.py's full-SLAM pass (bench.py:_make_slam_e2e with
enable_loop_closure()) on the CUDA device and then on the CPU, each time
recording the falign_pairs calls of its loop-closure links (stride 3: the
geometric stage, then the photometric one) and its keyframes' depth and
confidence maps. Prints:

* each pass's LC links (consistency, visibility) and Sim3 ATE;
* per keyframe, where the card's VO map departs from the CPU's: the
  relative depth difference (median, 99th percentile, largest), the
  confidence difference and the distance between the final positions;
* each card LC call solved again from its recorded inputs on the card and
  on the CPU, and the two-stage chain from the recorded geometric inputs on
  each device: whether a lane's result is the card's or the problem's;
* the keyframe publication order on the card: passes with the JAX package's
  order (a keyframe joins kf_ids before its loop-closure query) and with the
  port's (after it), alternating.

The recorded calls go to DIR/{card,cpu}_lc_calls.pkl (default _dev/lc_card,
a gitignored directory); `tools/lc_port_vs_jax_cpu.py --cross DIR` solves
them with the JAX package's falign as well.
"""

from __future__ import annotations

import argparse
import pickle
import sys
import threading
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))  # synthetic.py renders the scene


def summary(np, rets):
    return [(round(float(np.nanmean(r["consistency_mat"])), 4),
             round(float(np.nanmean(r["visibility_mat"])), 4), r["iters_coarse"], r["iters"],
             np.round(r["poses_ret"][1], 4).tolist()) for r in rets]


def publish_before_query(self, fid):
    """The JAX package's append_kf order (voldor_tpu/slam/system.py:1120):
    the keyframe joins kf_ids, then its loop-closure query runs."""
    self.frames[fid].is_keyframe = True
    self.kf_ids.append(fid)
    if self._use_loop_closure:
        self._loop_closure_query(fid, len(self.kf_ids) - 1)


def run_pass(np, sc, device, falign_api, jax_order=False):
    """One vo_thread + mapping_thread pass; returns (slam, LC calls, LC
    link events, Sim3 ATE)."""
    import chip_smoke as cs
    from voldor_tpu_torch.utils.evaluation import ate_rmse

    calls, events = [], []
    real = falign_api.falign_pairs

    def recording(**kw):
        out = real(**kw)
        if kw["stride"] == 3:  # the loop-closure settings
            calls.append(({k: v for k, v in kw.items() if k != "device"},
                          [{k: np.asarray(v) for k, v in r.items()} for r in out]))
        return out

    falign_api.falign_pairs = recording
    try:
        slam = cs.make_full_slam(sc, device=device)
        if jax_order:
            slam.append_kf = types.MethodType(publish_before_query, slam)
        slam.metrics.log = lambda event, **kw: events.append(dict(event=event, **kw))
        threads = [threading.Thread(target=slam.vo_thread), threading.Thread(target=slam.mapping_thread)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        falign_api.falign_pairs = real
    gt = np.linalg.inv(sc["Ts"])
    est = np.stack([f.Tcw for f in slam.frames]).astype(np.float64)
    links = [(tuple(int(k) for k in e["kf_ids"]), round(float(e["consistency"]), 4),
              round(float(e["visibility"]), 4), bool(e["accepted"]))
             for e in events if e["event"] == "lc_link"]
    return slam, calls, links, ate_rmse(est, gt, with_scale=True)


def map_diffs(np, card, cpu):
    """Per keyframe: relative depth difference (median, p99, max), largest
    confidence difference, distance between the final positions."""
    out = {}
    for k in card.kf_ids:
        if k not in cpu.kf_ids:
            continue
        a, b = card.frames[k], cpu.frames[k]
        da, db = np.asarray(a.depth, np.float64), np.asarray(b.depth, np.float64)
        rel = np.abs(da - db) / np.maximum(np.abs(db), 1e-6)
        rel = rel[np.isfinite(rel)]
        conf = float(np.nanmax(np.abs(np.asarray(a.depth_conf, np.float64)
                                      - np.asarray(b.depth_conf, np.float64))))
        pos = float(np.linalg.norm(np.linalg.inv(a.Tcw)[:3, 3] - np.linalg.inv(b.Tcw)[:3, 3]))
        out[int(k)] = (round(float(np.median(rel)), 6), round(float(np.percentile(rel, 99)), 6),
                       round(float(rel.max()), 6), round(conf, 6), round(pos, 6))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "_dev" / "lc_card"),
                    help="directory for the recorded loop-closure calls")
    ap.add_argument("--order_passes", type=int, default=2,
                    help="passes of each publication order in the A/B")
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs
    import voldor_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from voldor_tpu_torch.falign import api as falign_api

    cs.phase_device(torch)
    cs.phase_build()
    sc = cs.build_slam_scene(np, torch, cs.SLAM_E2E_FLOWS)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    passes = {}
    for dev in ("cuda", "cpu"):
        passes[dev] = run_pass(np, sc, dev, falign_api)
        slam, calls, links, ate = passes[dev]
        print(f"[pass] {dev}: keyframes {slam.kf_ids}, candidates {slam.lc_candidates}, LC links "
              f"(kf_ids, consistency, visibility, accepted) {links}, Sim3 ATE {ate:.6f}", flush=True)
        with open(out / f"{'card' if dev == 'cuda' else 'cpu'}_lc_calls.pkl", "wb") as f:
            pickle.dump(calls, f)
    diffs = map_diffs(np, passes["cuda"][0], passes["cpu"][0])
    print("[maps] card vs CPU per keyframe (depth |rel diff| median, p99, max; confidence max "
          "|diff|; final position distance):", flush=True)
    for k, v in diffs.items():
        print(f"[maps]   keyframe {k}: {v}", flush=True)

    calls = passes["cuda"][1]
    print(f"{len(calls)} loop-closure falign calls on the card", flush=True)
    for i, (kw, res) in enumerate(calls):
        stage = "photo" if kw.get("images") is not None else "geo"
        print(f"call {i} ({stage}) in the pass: {summary(np, res)}")
        for dev in ("cuda", "cpu"):
            print(f"  again on {dev}: {summary(np, falign_api.falign_pairs(**kw, device=dev))}",
                  flush=True)
    geo = [c[0] for c in calls if c[0].get("images") is None]
    photo = [c[0] for c in calls if c[0].get("images") is not None]
    for geo_kw, photo_kw in zip(geo, photo):
        for dev in ("cuda", "cpu"):
            g = falign_api.falign_pairs(**geo_kw, device=dev)
            kw2 = dict(photo_kw, poses_init=np.stack([r["poses_ret"] for r in g]))
            print(f"the chain on {dev}: {summary(np, g)} -> "
                  f"{summary(np, falign_api.falign_pairs(**kw2, device=dev))}", flush=True)

    for i in range(args.order_passes):
        for jax_order in (True, False):
            _, _, links, ate = run_pass(np, sc, "cuda", falign_api, jax_order)
            print(f"[order] card, {'JAX order (before the query)' if jax_order else 'port order (after the query)'}"
                  f", pass {i}: LC links {links}, Sim3 ATE {ate:.6f}", flush=True)


if __name__ == "__main__":
    main()
