"""The ``tum-rgbd.handheld`` cell with the scale fit skipped, on the card:
the control that leaves each window at its monocular scale.

    python3 tools/rgbd_fit_skipped.py --seconds <s> --seeds <n> [--first <seed>]

From the root of a checkout. For each seed, sets the cell up as
``benchmark/run.py`` does, with ``VOLDOR_SLAM._mono_scaled_fit`` replaced by
a function that leaves the window as the engine solved it (the maps are
still copied to the host), runs the window and judges it as the cell does.
Prints a JSON line per seed and, last, each number's smallest reading: the
cell's limits on the poses, depth and ``scale_fit_gap`` have to refuse it.
A seed whose stream does not reach windows with both depth priors reads
every number as inf.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1] / "benchmark"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--first", type=int, default=2_400_000_017)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(BENCH.parent)]
    import run
    import torch

    from voldor_tpu_torch.slam.system import VOLDOR_SLAM

    VOLDOR_SLAM._mono_scaled_fit = lambda self, vo_ret: None
    cell = run.Cell(BENCH.parent, "tum-rgbd.handheld")
    least = {}
    for i in range(args.seeds):
        seed = args.first + 7919 * i
        ctx = run.Context(cell, seed, args.device, False, torch)
        drv = cell.driver(ctx)
        try:
            drv.setup()
            drv.window(args.seconds)
            ctx.sync()
            got = drv.judge()
        except RuntimeError as e:  # the stream never reached both priors
            print(f"seed {seed}: {e}", file=sys.stderr)
            got = {k: math.inf for k in cell.limits["numbers"]}
        drv.close()
        shutil.rmtree(ctx.tmp, ignore_errors=True)
        for k, v in got.items():
            least[k] = min(least.get(k, v), v)
        print(json.dumps({"seed": seed, "fit_skipped": got}), flush=True)
    print(json.dumps({"workload": "tum-rgbd.handheld", "seeds": args.seeds, "least_fit_skipped": least}),
          flush=True)


if __name__ == "__main__":
    main()
