"""Readings that the correctness limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> --seeds <n> [--first <seed>]

In one process (the kernels load once), for each of ``--seeds`` seeds: set
the cell up from the seed, run its window for ``--seconds`` at the cell's
own load, and judge what it produced twice: as published (the program's
reading) and with the control in the program's place (each published
motion replaced by the one published before it: the constant-velocity
extrapolation, which breaks the guarantee that every frame's pose is solved
from its own flows). Prints a JSON line per seed and, last, each number's
largest program reading and smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=2_000_000_011)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = run.BENCH.parent
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / ".bench_cache" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / ".bench_cache" / "triton")
    sys.path.insert(0, str(root))
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("calibration reads the card; no CUDA device")
    cell = run.Cell(root, args.workload)
    prog, ctrl = {}, {}
    for i in range(args.seeds):
        seed = args.first + 7919 * i
        ctx = run.Context(cell, seed, args.device, False, torch)
        drv = cell.driver(ctx)
        drv.setup()
        drv.window(args.seconds)
        ctx.sync()
        p, c = drv.judge(), drv.judge(control=True)
        drv.close()
        shutil.rmtree(ctx.tmp, ignore_errors=True)
        for k, v in p.items():
            prog[k] = max(prog.get(k, v), v) if cell.limits["numbers"].get(k, {}).get("kind") != "min" \
                else min(prog.get(k, v), v)
        for k, v in c.items():
            ctrl[k] = min(ctrl.get(k, v), v)
        print(json.dumps({"seed": seed, "program": p, "control": c}), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "worst_program": prog,
                      "least_control": ctrl}), flush=True)


if __name__ == "__main__":
    main()
