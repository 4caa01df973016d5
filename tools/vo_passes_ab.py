#!/usr/bin/env python3
"""slam-mono and slam-stereo frames/s of two checkouts of the repo in one
call on one card: the checkouts alternate (A, B, B, A), each run in a
process of its own started in that checkout, each run one checked pass and
three timed passes of chip_smoke.py's slam phases (the bench's 24-flow
scene). Prints each run's median frames/s per mode.

    python3 tools/vo_passes_ab.py A_DIR B_DIR

A_DIR and B_DIR are checkouts (e.g. `git archive` of two commits); each
builds its own kernels into its own voldor_tpu_torch/_build/.
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
import voldor_tpu_torch
from synthetic import plane_depth
cs.phase_build()
K, planes, _, flows, _, Ts, _ = cs.build_scene(np, torch, cs.SLAM_FLOWS)
gt = np.linalg.inv(Ts)
disps = [(cs.BF_STEREO / plane_depth(K, T[:3, :3], T[:3, 3], planes, cs.H, cs.W)).astype(np.float32)
         for T in Ts[:cs.SLAM_FLOWS]]
out = {}
_, out['mono'], _ = cs.phase_slam(np, torch, 'mono', flows, gt, n_timed=3)
_, out['stereo'], _ = cs.phase_slam(np, torch, 'stereo', flows, gt, disps=disps, n_timed=3)
print('[ab] ' + json.dumps(out), flush=True)
"""


def main():
    a, b = sys.argv[1:3]
    for d in (a, b, b, a):
        r = subprocess.run([sys.executable, "-c", CHILD], cwd=d, capture_output=True, text=True,
                           timeout=900)
        got = [ln for ln in r.stdout.splitlines() if ln.startswith("[ab] ")]
        print(f"{d}: exit {r.returncode} {got[-1] if got else r.stderr[-2000:]}", flush=True)


if __name__ == "__main__":
    main()
