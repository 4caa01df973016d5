#!/usr/bin/env python3
"""Device times of the pose sweep's three kernels (P4P, meanshift, the
robust-Gaussian refit) in two checkouts of the repo, in one call on one
card: the checkouts alternate (A, B, B, A), each run in a process of its
own started in that checkout, which builds its own kernels, records one
bench-scene window's fuse inputs and times the kernels with its own
chip_smoke.py (capture_pose_inputs, pose_times: bound C calls, 100
launches each, at B = 5 and B = 1). Prints each run's ms per launch.

    python3 tools/pose_kernels_ab.py A_DIR B_DIR
"""

from __future__ import annotations

import subprocess
import sys

CHILD = """
import json, sys
sys.path.insert(0, '.')
sys.path.insert(0, 'tests')
import numpy as np, torch
import chip_smoke as cs
cs.phase_device(torch)
cs.phase_build()
scene = cs.build_scene(np, torch, cs.N_WINDOWS * cs.WINDOW)
rec = cs.pose_times(np, torch, cs.capture_pose_inputs(np, torch, scene))
out = {B: {k: rec[B][k]['ms'] for k in ('p4p', 'meanshift', 'rg')} for B in (cs.WINDOW, 1)}
print('[pose-ab] ' + json.dumps(out), flush=True)
"""


def main():
    a, b = sys.argv[1:3]
    for d in (a, b, b, a):
        r = subprocess.run([sys.executable, "-c", CHILD], cwd=d, capture_output=True, text=True,
                           timeout=900)
        got = [ln for ln in r.stdout.splitlines() if ln.startswith("[pose-ab] ")]
        print(f"{d}: exit {r.returncode} {got[-1] if got else r.stderr[-2000:]}", flush=True)


if __name__ == "__main__":
    main()
