#!/usr/bin/env python3
"""The full-SLAM pass with the mapping thread's device work on a CUDA stream
of its own, against the same pass with all work on the default stream.

    python3 tools/mapping_stream_ab.py [--rounds 2]

Runs chip_smoke.py's slam-full-mono pass (run_full_slam: vo_thread and
mapping_thread as two threads over the bench's full-SLAM scene, loop
closure off) once to warm, then `rounds` rounds of (side stream, default,
default, side stream). In the side-stream arm every falign_pairs and pgo
call (the mapping thread's device work; their inputs and outputs are host
arrays) runs inside torch.cuda.stream of one stream made for the pass.
Prints each pass (frames/s, falign and PGO seconds, the mapping seconds
inside VO windows) and, last, the arms' frames/s as one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def side_stream(torch, modules):
    """Run module.name (for each (module, name)) inside one side stream."""
    stream = torch.cuda.Stream()
    real = [(m, n, getattr(m, n)) for m, n in modules]

    def wrap(fn):
        def on_stream(*a, **k):
            with torch.cuda.stream(stream):
                return fn(*a, **k)
        return on_stream

    for m, n, fn in real:
        setattr(m, n, wrap(fn))
    try:
        yield
    finally:
        for m, n, fn in real:
            setattr(m, n, fn)


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from voldor_tpu_torch.falign import api as falign_api
    from voldor_tpu_torch.pgo import api as pgo_api

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    cs.phase_device(torch)
    cs.phase_build()
    sc = cs.build_slam_scene(np, torch, cs.SLAM_E2E_FLOWS)
    n_frames = sc["flows"].shape[0] + 1
    cs.run_full_slam(np, torch, sc)  # warm
    fps = {"stream": [], "default": []}
    for _ in range(args.rounds):
        for arm in ("stream", "default", "default", "stream"):
            ctx = (side_stream(torch, [(falign_api, "falign_pairs"), (pgo_api, "pgo")])
                   if arm == "stream" else contextlib.nullcontext())
            with ctx:
                _, dt, st = cs.run_full_slam(np, torch, sc)
            fps[arm].append(n_frames / dt)
            mapping = st["falign_s"] + st["pgo_s"]
            print(f"{arm}: {n_frames / dt:.4f} frames/s ({dt:.4f} s); falign {st['falign_s']:.4f} s "
                  f"in {st['falign_calls']} calls, PGO {st['pgo_s']:.4f} s, VO windows "
                  f"{st['vo_s']:.4f} s; mapping inside VO windows {st['overlap_s']:.4f} s "
                  f"({100 * st['overlap_s'] / max(mapping, 1e-9):.1f}%); links "
                  f"{st['accepted']}/{st['links']}; alive {st['alive']}", flush=True)
    print(json.dumps({arm: dict(fps=v, median=statistics.median(v), spread=max(v) - min(v))
                      for arm, v in fps.items()}))


if __name__ == "__main__":
    main()
