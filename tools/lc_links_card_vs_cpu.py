#!/usr/bin/env python3
"""The loop-closure link batches of one slam-full-mono pass on the card,
solved again from the same inputs on the card and on the CPU.

    python3 tools/lc_links_card_vs_cpu.py

Runs chip_smoke.py's full-SLAM pass (bench.py:_make_slam_e2e with
enable_loop_closure()) on the CUDA device, records the falign_pairs calls of
its loop-closure links (stride 3: the geometric stage, then the photometric
one), and solves each call again on the card and on the CPU from the
recorded inputs; then the two-stage chain from the recorded geometric
inputs on each device. Prints, per lane, consistency, visibility, the
iterations (coarse, fine) and the second frame's pose: whether a lane's
result is the card's or the problem's.
"""

from __future__ import annotations

import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))  # synthetic.py renders the scene


def summary(np, rets):
    return [(round(float(np.nanmean(r["consistency_mat"])), 4),
             round(float(np.nanmean(r["visibility_mat"])), 4), r["iters_coarse"], r["iters"],
             np.round(r["poses_ret"][1], 4).tolist()) for r in rets]


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    import voldor_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from voldor_tpu_torch.falign import api as falign_api

    cs.phase_device(torch)
    cs.phase_build()
    sc = cs.build_slam_scene(np, torch, cs.SLAM_E2E_FLOWS)
    calls = []
    real = falign_api.falign_pairs

    def recording(**kw):
        out = real(**kw)
        if kw["stride"] == 3:  # the loop-closure settings
            calls.append(({k: v for k, v in kw.items() if k != "device"}, out))
        return out

    falign_api.falign_pairs = recording
    try:
        slam = cs.make_full_slam(sc)
        threads = [threading.Thread(target=slam.vo_thread), threading.Thread(target=slam.mapping_thread)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        falign_api.falign_pairs = real
    print(f"{len(calls)} loop-closure falign calls; candidates {slam.lc_candidates}")
    for i, (kw, out) in enumerate(calls):
        stage = "photo" if "images" in kw else "geo"
        print(f"call {i} ({stage}) in the pass: {summary(np, out)}")
        for dev in ("cuda", "cpu"):
            print(f"  again on {dev}: {summary(np, real(**kw, device=dev))}")
    for geo_kw, photo_kw in zip([c[0] for c in calls[::2]], [c[0] for c in calls[1::2]]):
        for dev in ("cuda", "cpu"):
            geo = real(**geo_kw, device=dev)
            kw2 = dict(photo_kw, poses_init=np.stack([r["poses_ret"] for r in geo]))
            print(f"the chain on {dev}: {summary(np, geo)} -> {summary(np, real(**kw2, device=dev))}",
                  flush=True)


if __name__ == "__main__":
    main()
