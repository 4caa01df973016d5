#!/usr/bin/env python3
"""Device time of the cost kernel of two checkouts of the repo in one call
on one card: the checkouts alternate (A, B, B, A), each run in a process of
its own started in that checkout, so each calls its own
`voldor_tpu_torch.ops.cost` wrappers (and with them its own kernel and
entry point). Each run builds the bench scene's 5-frame window with two
priors at 613x185 through that checkout's `chip_smoke.py` helpers
(`build_scene`, `bench_inputs`, `planes_at`), checks the kernel's score
mode against that checkout's plain version on the card, captures N_CALLS
wrapper calls in a CUDA graph and times its replays with CUDA events (the
device's time alone, no host work between launches; each call's pose-row
copy included), in score mode and in accept mode without and with masks
(of the jump-flood family's kind, as `chip_smoke.shift_masks` makes them)
at K = 1, 4, 10 and 16.

    python3 tools/cost_kernel_ab.py A_DIR B_DIR

A_DIR and B_DIR are checkouts (e.g. `git archive` of two commits); each
builds its own kernels into its own voldor_tpu_torch/_build/. Prints a line
per run and, last, one JSON object: each checkout's least graph time per
launch by shape ("score K=1", "accept K=4", "accept K=4 masked", ...) and
its largest score-mode difference from its plain version. `chip_smoke.py
--parent` weights the times by the launches of its main path.
"""

from __future__ import annotations

import json
import subprocess
import sys

CHILD = """
import json, sys
sys.path.insert(0, '.')
sys.path.insert(0, 'tests')
import numpy as np, torch
import chip_smoke as cs
from voldor_tpu_torch.ops import cost as cm
from voldor_tpu_torch.vo import em
N_CALLS = 50
scene = cs.build_scene(np, torch, cs.SLAM_FLOWS)
bi = cs.bench_inputs(np, torch, scene)
rig, track, tinb, ps = cs.planes_at(bi, cs.WINDOW, 2)
planes = (track, tinb, rig, bi['Rs'], bi['ts'], cs.WINDOW, bi['p'])
ca = bi['cands_all']
cands = {k: (ca[:k] if k <= 10 else torch.cat([ca, ca[1:k - 9] * 1.03])).contiguous()
         for k in (1, 4, 10, 16)}
cost0 = cm.cost_map_score(bi['d0'][None].contiguous(), *planes, prior_samples=ps)[0].clone()

def timed(fn):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / N_CALLS

rec = dict(ms={}, max_abs_err={})
for k, c in cands.items():
    ref = cm.normalize_cost(*cm.cost_map_tracked_reference(c, *planes, prior_samples=ps))
    got = cm.cost_map_score(c, *planes, prior_samples=ps)
    fin = torch.isfinite(ref)
    if not torch.equal(fin, torch.isfinite(got)):
        sys.exit(f'K={k}: the +inf pattern differs from the plain version')
    rec['max_abs_err'][k] = float((got[fin] - ref[fin]).abs().max())
    depth, cost = bi['d0'].clone(), cost0.clone()
    masks = torch.stack([em._shift_depth(bi['d0'], sy * (i // 4 + 1), sx * (i // 4 + 1))[1]
                         for i, (sy, sx) in ((i, em._LOCAL_DIRS[i % 4]) for i in range(k))])
    calls = {f'score K={k}': lambda: cm.cost_map_score(c, *planes, prior_samples=ps),
             f'accept K={k}': lambda: cm.cost_map_accept(depth, cost, c, None, *planes,
                                                         prior_samples=ps),
             f'accept K={k} masked': lambda: cm.cost_map_accept(depth, cost, c, masks, *planes,
                                                                prior_samples=ps)}
    for shape, fn in calls.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(N_CALLS):
                fn()
        graph.replay()
        rec['ms'][shape] = min(timed(graph.replay) for _ in range(5))
        del graph
print('[ab] ' + json.dumps(rec), flush=True)
"""

def main():
    a, b = sys.argv[1:3]
    runs = {a: [], b: []}
    for d in (a, b, b, a):
        r = subprocess.run([sys.executable, "-c", CHILD], cwd=d, capture_output=True, text=True,
                           timeout=900)
        got = [ln for ln in r.stdout.splitlines() if ln.startswith("[ab] ")]
        print(f"{d}: exit {r.returncode} {got[-1] if got else r.stderr[-2000:]}", flush=True)
        if r.returncode != 0 or not got:
            sys.exit(f"the run in {d} failed")
        runs[d].append(json.loads(got[-1][5:]))
    out = {}
    for name, d in (("a", a), ("b", b)):
        out[name] = dict(ms={shape: min(r["ms"][shape] for r in runs[d]) for shape in runs[d][0]["ms"]},
                         max_abs_err=max(max(r["max_abs_err"].values()) for r in runs[d]))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
