#!/usr/bin/env python3
"""The dense PGO's LM iteration on a CUDA device: time per iteration and
kernel launches per iteration at 60 and 600 poses.

    python3 tools/pgo_dense_times.py [--iters 12] [--repeats 3] [--tag NAME]

Solves chip_smoke.py's drifted circle graph (seed n) with
pgo_solve_dense_jit for --iters LM iterations, once to warm and then
--repeats times, each synchronised on both sides; prints the median time
per iteration, the launches per iteration (torch.profiler) and, last, one
JSON object. It measures the checkout it lies in: copied into another
checkout's tools/, it measures that checkout (an A/B in one call).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from voldor_tpu_torch.pgo import solver as pgo_solver

    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--tag", default=str(ROOT))
    args = ap.parse_args()

    cs.phase_device(torch)
    out = {"tag": args.tag}
    for n in (60, 600):
        g = cs.circle_graph(np, torch, n, seed=n)
        prob, _, _ = pgo_solver.build_problem(g[0], None, g[1], g[2], g[3], False,
                                              torch.device("cuda"))
        pgo_solver.pgo_solve_dense_jit(prob, max_iters=args.iters)  # warm
        per_iter = []
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, iters = pgo_solver.pgo_solve_dense_jit(prob, max_iters=args.iters)
            iters = int(iters)
            torch.cuda.synchronize()
            per_iter.append((time.perf_counter() - t0) / iters * 1e3)
        launches, syncs, _ = cs.profile_counts(
            torch, lambda: pgo_solver.pgo_solve_dense_jit(prob, max_iters=args.iters))
        out[n] = dict(ms_per_iter=statistics.median(per_iter), runs_ms=per_iter, iters=iters,
                      launches_per_iter=launches / iters, syncs=syncs)
        print(f"[{args.tag}] dense PGO n={n}: {out[n]['ms_per_iter']:.3f} ms per LM iteration "
              f"(runs {[round(x, 3) for x in per_iter]}, {iters} iterations each), "
              f"{launches / iters:.1f} launches per iteration, {syncs} syncs per solve", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
