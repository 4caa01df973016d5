#!/usr/bin/env python3
"""Where the host syncs, host copies and kernel launches of the port's
mapping work come from, on a CUDA device.

    python3 tools/profile_torch_mapping.py

Times falign_pairs on 4 and 16 keyframe pairs of the full-SLAM scene at
the local-link settings (chip_smoke.py's falign_batch, with images; median
of 3 calls after a warm one) and profiles one more call of each
(torch.profiler), as well as four LM iterations of a 60-pose dense PGO
solve (chip_smoke.py's circle_graph): every cudaStreamSynchronize /
cudaMemcpyAsync is attributed to the outermost aten op that encloses it on
the same thread. Then counts the syncs of the batched linear-algebra calls
the LM solvers use, at their shapes, against triangular solves. The two
syncs of the profiler's own closing synchronize show as "(no aten op)".

Run from another checkout's root (a copy of this file in its tools/), it
measures that checkout: two checkouts in one call compare on one card.
"""

from __future__ import annotations

import collections
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
COPIES = ("cudaMemcpyAsync",)


def attribute(torch, fn):
    """Run fn under the profiler; return {kind: Counter(outermost aten op)}
    and the count of kernel launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = prof.events()
    ops = collections.defaultdict(list)
    for e in evs:
        if e.name.startswith("aten::"):
            ops[e.thread].append(e)
    out = {"sync": collections.Counter(), "copy": collections.Counter()}
    launches = 0
    for e in evs:
        if e.name.startswith("cudaLaunchKernel"):
            launches += 1
        kind = "sync" if e.name in SYNCS else "copy" if e.name in COPIES else None
        if kind is None:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        enclosing = [o for o in ops[e.thread] if o.time_range.start <= t0 and o.time_range.end >= t1]
        name = (min(enclosing, key=lambda o: o.time_range.start).name if enclosing
                else "(no aten op)")
        out[kind][name] += 1
    return out, launches


def linalg_counts(torch):
    """Syncs, copies and launches of the solvers' linear algebra at their
    shapes: falign's (L, 18, 18) systems, PGO's dense (420, 420)."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def spd(*shape):
        a = torch.randn(*shape, generator=gen, device="cuda")
        return a @ a.transpose(-1, -2) + shape[-1] * torch.eye(shape[-1], device="cuda")

    rows = []
    for name, A in (("falign L=4 D=18", spd(4, 18, 18)), ("falign L=16 D=18", spd(16, 18, 18)),
                    ("pgo dense D=420", spd(420, 420))):
        b = torch.randn(A.shape[:-1] + (1,), generator=gen, device="cuda")
        Lc, _ = torch.linalg.cholesky_ex(A)
        cases = {
            "cholesky_ex": lambda: torch.linalg.cholesky_ex(A),
            "cholesky_solve": lambda: torch.cholesky_solve(b, Lc),
            "2 x solve_triangular": lambda: torch.linalg.solve_triangular(
                Lc.transpose(-1, -2), torch.linalg.solve_triangular(Lc, b, upper=False),
                upper=True),
        }
        for case, fn in cases.items():
            fn()
            torch.cuda.synchronize()
            c, launches = attribute(torch, fn)
            rows.append((name, case, sum(c["sync"].values()), sum(c["copy"].values()), launches))
    return rows


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import chip_smoke as cs
    from voldor_tpu_torch.falign import api as falign_api
    from voldor_tpu_torch.pgo import solver as pgo_solver

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"preferred linalg {torch.backends.cuda.preferred_linalg_library()}")
    sc = cs.build_slam_scene(np, torch, cs.SLAM_E2E_FLOWS)
    for n_pairs in (4, 16):
        _, kw = cs.falign_batch(np, torch, sc, n_pairs, True)
        falign_api.falign_pairs(**kw, device="cuda")  # warm
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            falign_api.falign_pairs(**kw, device="cuda")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        c, launches = attribute(torch, lambda: falign_api.falign_pairs(**kw, device="cuda"))
        print(f"[falign_pairs {n_pairs} pairs] {statistics.median(times):.4f} s per call (median "
              f"of {[round(t, 4) for t in times]}); launches {launches}; syncs by op "
              f"{dict(c['sync'])}; copies by op {dict(c['copy'])}")

    g = cs.circle_graph(np, torch, 60, 60)
    prob, _, _ = pgo_solver.build_problem(g[0], None, g[1], g[2], g[3], False,
                                          torch.device("cuda"))
    pgo_solver.pgo_solve_dense_jit(prob, max_iters=4)
    c, launches = attribute(torch, lambda: pgo_solver.pgo_solve_dense_jit(prob, max_iters=4))
    print(f"[pgo dense 60 poses, 4 LM iterations] launches {launches}; syncs by op "
          f"{dict(c['sync'])}; copies by op {dict(c['copy'])}")

    for name, case, syncs, copies, launches in linalg_counts(torch):
        print(f"[linalg] {name} {case}: syncs {syncs}, copies {copies}, launches {launches}")


if __name__ == "__main__":
    main()
