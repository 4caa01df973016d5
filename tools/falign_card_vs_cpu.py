#!/usr/bin/env python3
"""falign_pairs on a CUDA device against the same call on the CPU, over
several seeded batches: the readings chip_smoke.py's falign limits
(FALIGN_LIMITS) are set from.

    python3 tools/falign_card_vs_cpu.py [--seeds 104,1,2,3,4,5] [--lc_seeds 200,1,2,3,4,5]
        [--kinds geo,photo,lc]

Each seed draws chip_smoke.py's falign_batch (four keyframe pairs of the
full-SLAM scene; the depth noise, confidences and init error come from the
seed; 104 is chip_smoke.py's own batch), geometric and photometric +
geometric, and each LC seed its loop-closure batch (falign_lc_batch: the
scene's four revisit pairs at the loop-closure settings, geometric stage
then photometric; 200 is chip_smoke.py's own). Each batch runs on the card,
on the CPU, and on the CPU with its init moved by 1e-6 (the CPU's own
spread; for the LC batch, the geometric stage's identity init). Prints one line per lane
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
sys.path.insert(0, str(ROOT / "tests"))  # synthetic.py renders the scene


def main():
    import numpy as np
    import torch

    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="104,1,2,3,4,5")
    ap.add_argument("--lc_seeds", default="200,1,2,3,4,5")
    ap.add_argument("--kinds", default="geo,photo,lc")
    args = ap.parse_args()
    kinds = args.kinds.split(",")
    runs = [(kind, int(seed)) for kind in kinds
            for seed in (args.lc_seeds if kind == "lc" else args.seeds).split(",")]

    cs.phase_device(torch)
    sc = cs.build_slam_scene(np, torch, cs.SLAM_E2E_FLOWS)
    keys = ("iters_off", "rot", "trans", "truth_rot", "truth_rot_cpu", "scale", "score")
    nudge_keys = ("iters", "rot", "trans", "scale", "score")
    worst = {kind: dict.fromkeys(keys + ("truth_excess",) + tuple(f"nudge_{k}" for k in nudge_keys),
                                 0.0)
             for kind in kinds}
    for kind, seed in runs:
        t0 = time.perf_counter()
        pairs, _, card = cs.falign_run(np, torch, sc, kind, "cuda", seed=seed)
        _, _, cpu = cs.falign_run(np, torch, sc, kind, "cpu", seed=seed)
        _, _, nudged = cs.falign_run(np, torch, sc, kind, "cpu", seed=seed, nudge=1e-6)
        lanes = cs.falign_lanes(np, torch, sc, pairs, card, cpu)
        spread = cs.falign_lanes(np, torch, sc, pairs, nudged, cpu)
        for ln, sp in zip(lanes, spread):
            w = worst[kind]
            for k in keys:
                w[k] = max(w[k], ln[k])
            w["truth_excess"] = max(w["truth_excess"], ln["truth_rot"] - ln["truth_rot_cpu"])
            for k in nudge_keys:
                w[f"nudge_{k}"] = max(w[f"nudge_{k}"], sp["iters_off" if k == "iters" else k])
            print(f"seed {seed} {kind} lane {ln['pair']}: iterations card {ln['iters']} cpu "
                  f"{ln['iters_cpu']} nudged cpu {sp['iters']}; card vs cpu rotation "
                  f"{ln['rot']:.3e} rad, translation {ln['trans']:.3e}, scale ratio {ln['scale']:.3e}, "
                  f"scores {ln['score']:.3e}; nudged vs cpu {sp['rot']:.3e} / {sp['trans']:.3e} / "
                  f"{sp['scale']:.3e} / {sp['score']:.3e}; rotation to the true pose card "
                  f"{ln['truth_rot']:.3e} cpu {ln['truth_rot_cpu']:.3e}", flush=True)
        print(f"seed {seed} {kind}: {time.perf_counter() - t0:.1f} s for the three runs",
              flush=True)
    print(json.dumps({"runs": runs, "worst": worst}))


if __name__ == "__main__":
    main()
