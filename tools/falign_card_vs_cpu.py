#!/usr/bin/env python3
"""falign_pairs on a CUDA device against the same call on the CPU, over
several seeded batches: the readings chip_smoke.py's falign limits
(FALIGN_LIMITS, FALIGN_TRUTH_ROT) are set from.

    python3 tools/falign_card_vs_cpu.py [--seeds 104,1,2,3,4,5]

Each seed draws chip_smoke.py's falign_batch (four keyframe pairs of the
full-SLAM scene; the depth noise, confidences and init error come from the
seed; 104 is chip_smoke.py's own batch), geometric and photometric +
geometric. Each batch runs on the card, on the CPU, and on the CPU with
its init moved by 1e-6 (the CPU's own spread). Prints one line per lane
(iterations, rotation angle and translation between the runs, rotation
angle to the true relative pose) and, last, the largest of each over the
seeds per kind of batch as one JSON object (truth_excess: how much farther
from the true rotation the card landed than the CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from voldor_tpu_torch.falign import api as falign_api

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="104,1,2,3,4,5")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]

    cs.phase_device(torch)
    sc = cs.build_slam_scene(np, torch, cs.SLAM_E2E_FLOWS)
    keys = ("iters_off", "rot", "trans", "truth_rot", "truth_rot_cpu")
    worst = {kind: dict.fromkeys(keys + ("truth_excess", "nudge_iters", "nudge_rot", "nudge_trans"),
                                 0.0)
             for kind in ("geo", "photo")}
    for seed in seeds:
        for photo in (False, True):
            kind = "photo" if photo else "geo"
            pairs, kw = cs.falign_batch(np, torch, sc, 4, photo, seed=seed)
            t0 = time.perf_counter()
            card = falign_api.falign_pairs(**kw, device="cuda")
            cpu = falign_api.falign_pairs(**kw, device="cpu")
            nudged = falign_api.falign_pairs(**dict(kw, poses_init=kw["poses_init"] + 1e-6),
                                             device="cpu")
            lanes = cs.falign_lanes(np, torch, sc, pairs, card, cpu)
            spread = cs.falign_lanes(np, torch, sc, pairs, nudged, cpu)
            for ln, sp in zip(lanes, spread):
                w = worst[kind]
                for k in keys:
                    w[k] = max(w[k], ln[k])
                w["truth_excess"] = max(w["truth_excess"], ln["truth_rot"] - ln["truth_rot_cpu"])
                w["nudge_iters"] = max(w["nudge_iters"], sp["iters_off"])
                w["nudge_rot"] = max(w["nudge_rot"], sp["rot"])
                w["nudge_trans"] = max(w["nudge_trans"], sp["trans"])
                print(f"seed {seed} {kind} lane {ln['pair']}: iterations card {ln['iters']} cpu "
                      f"{ln['iters_cpu']} nudged cpu {sp['iters']}; card vs cpu rotation "
                      f"{ln['rot']:.3e} rad, translation {ln['trans']:.3e}; nudged vs cpu "
                      f"{sp['rot']:.3e} / {sp['trans']:.3e}; rotation to the true pose card "
                      f"{ln['truth_rot']:.3e} cpu {ln['truth_rot_cpu']:.3e}", flush=True)
            print(f"seed {seed} {kind}: {time.perf_counter() - t0:.1f} s for the three runs",
                  flush=True)
    print(json.dumps({"seeds": seeds, "worst": worst}))


if __name__ == "__main__":
    main()
