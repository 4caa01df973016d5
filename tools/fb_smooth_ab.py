#!/usr/bin/env python3
"""Device time of the fb_smooth kernel of two checkouts of the repo in one
call on one card: the checkouts alternate (A, B, B, A), each run in a
process of its own started in that checkout, so each calls its own
`voldor_tpu_torch.ops.fb_smooth.fb_smooth` wrapper (and with it its own
kernel and entry point). Each run smooths one seeded (5, 185, 613) stack,
the rigidness stack of a 5-flow window: it checks the kernel against that
checkout's `fb_smooth_reference` on the card, captures N_CALLS wrapper
calls in a CUDA graph and times its replays with CUDA events, so the time
is the device's alone (no host work between launches), and times the same
calls back to back without the graph beside it.

    python3 tools/fb_smooth_ab.py A_DIR B_DIR

A_DIR and B_DIR are checkouts (e.g. `git archive` of two commits); each
builds its own kernels into its own voldor_tpu_torch/_build/. Prints a line
per run and, last, one JSON object: each checkout's least graph time per
call, its back-to-back time and its largest difference from its plain
version.
"""

from __future__ import annotations

import json
import subprocess
import sys

CHILD = """
import json, sys
sys.path.insert(0, '.')
import numpy as np, torch
from voldor_tpu_torch.ops import fb_smooth as fb
EMM, NCP, N_CALLS = 0.5, 0.9, 100  # the shipped fb_emm / fb_no_change_prob
x = np.random.default_rng(0).uniform(0.0, 1.0, (5, 185, 613)).astype(np.float32)
x = torch.as_tensor(x, device='cuda')
err = float((fb.fb_smooth(x, EMM, NCP) - fb.fb_smooth_reference(x, EMM, NCP)).abs().max())
side = torch.cuda.Stream()
side.wait_stream(torch.cuda.current_stream())
with torch.cuda.stream(side):
    for _ in range(3):
        fb.fb_smooth(x, EMM, NCP)
torch.cuda.current_stream().wait_stream(side)
graph = torch.cuda.CUDAGraph()
with torch.cuda.graph(graph):
    for _ in range(N_CALLS):
        fb.fb_smooth(x, EMM, NCP)

def timed(fn):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / N_CALLS

def eager():
    for _ in range(N_CALLS):
        fb.fb_smooth(x, EMM, NCP)

graph.replay()
graph_ms = [timed(graph.replay) for _ in range(5)]
eager_ms = [timed(eager) for _ in range(3)]
print('[ab] ' + json.dumps(dict(graph_ms=graph_ms, eager_ms=eager_ms, max_abs_err=err)), flush=True)
"""


def main():
    a, b = sys.argv[1:3]
    runs = {a: [], b: []}
    for d in (a, b, b, a):
        r = subprocess.run([sys.executable, "-c", CHILD], cwd=d, capture_output=True, text=True,
                           timeout=600)
        got = [ln for ln in r.stdout.splitlines() if ln.startswith("[ab] ")]
        print(f"{d}: exit {r.returncode} {got[-1] if got else r.stderr[-2000:]}", flush=True)
        if r.returncode != 0 or not got:
            sys.exit(f"the run in {d} failed")
        runs[d].append(json.loads(got[-1][5:]))
    print(json.dumps({name: {"ms": min(min(r["graph_ms"]) for r in runs[d]),
                             "eager_ms": min(min(r["eager_ms"]) for r in runs[d]),
                             "max_abs_err": max(r["max_abs_err"] for r in runs[d])}
                      for name, d in (("a", a), ("b", b))}), flush=True)


if __name__ == "__main__":
    main()
