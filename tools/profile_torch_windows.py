#!/usr/bin/env python3
"""Where a VO window's time goes in the PyTorch + CUDA port, on one GPU.

    python3 tools/profile_torch_windows.py [TABLES_PATH]

Runs the three consecutive 5-flow bench-scene windows of chip_smoke.py
(0, 1 and 2 depth priors; 613x185) once to warm up, then:

1. layer shares: the same three windows with synchronised host timers
   around the solve's layers (pose sweep, depth round, and inside the depth
   round fb_smooth, the cost kernel's wrappers and the rigidness refresh);
   the rest of the window wall (init, bootstrap, the solve loop's own host
   work, confidence) is reported as "other";
2. torch.profiler (CPU and CUDA activities) over the three windows: wall,
   the device's busy time (the union of its kernel and copy intervals) and
   idle share, the count of kernel launches, host-device syncs and
   device-to-host copies, and the largest rows by device and by host time.

The full profiler tables are written to TABLES_PATH when one is given.
Needs a CUDA device; prints the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import chip_smoke as cs
    from voldor_tpu_torch.vo import engine as engine_mod

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(f"[device] {smi}", flush=True)
    scene = cs.build_scene(np, torch, cs.N_WINDOWS * cs.WINDOW)
    cs.run_sequence(np, torch, scene)  # warm-up: builds the kernels, fills the caches

    # 1. layer shares under synchronised timers
    spent = {}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t
        return wrapper

    layers = {
        "pose sweep (seq)": "_cameras_window_core",
        "pose sweep (jacobi)": "_cameras_window_jacobi_core",
        "depth round": "_depth_round_core",
    }
    inner = {  # names the depth round looks up in engine's namespace
        "  fb_smooth": "fb_smooth",
        "  cost score": "cost_map_score",
        "  cost accept": "cost_map_accept",
    }
    em_inner = {
        "  rigidness refresh": "update_rigidness_and_tracks",
    }
    saved = {}
    for label, name in {**layers, **inner}.items():
        saved[(engine_mod, name)] = getattr(engine_mod, name)
        setattr(engine_mod, name, timed(label, getattr(engine_mod, name)))
    for label, name in em_inner.items():
        saved[(engine_mod.em, name)] = getattr(engine_mod.em, name)
        setattr(engine_mod.em, name, timed(label, getattr(engine_mod.em, name)))
    try:
        _, walls, iters, _ = cs.run_sequence(np, torch, scene)
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    wall = sum(walls)
    top = sum(v for k, v in spent.items() if not k.startswith("  "))
    print(f"[layers] 3 windows, EM iterations {iters}, wall {wall:.4f} s "
          f"(per window {[round(x, 4) for x in walls]}), synchronised timers:", flush=True)
    for label in list(layers) + list(inner) + list(em_inner):
        if label in spent:
            print(f"[layers] {label}: {spent[label]:.4f} s ({100 * spent[label] / wall:.1f}%)")
    print(f"[layers] other (init, bootstrap, solve-loop host work, confidence): "
          f"{wall - top:.4f} s ({100 * (wall - top) / wall:.1f}%)", flush=True)

    # 2. the profiler over the same three windows, no timers
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cs.run_sequence(np, torch, scene)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for s, e in dev:  # union of the device intervals, in us
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    span = (dev[-1][1] - dev[0][0]) if dev else 0.0
    count = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and (
                e.name.startswith("cuda") or e.name.startswith("aten::item")
                or e.name in ("aten::_local_scalar_dense",)):
            count[e.name] = count.get(e.name, 0) + 1
    print(f"[profile] wall {wall:.4f} s; device busy {busy / 1e6:.4f} s of a "
          f"{span / 1e6:.4f} s device span ({100 * (1 - busy / span):.1f}% idle); "
          f"device intervals {len(dev)}", flush=True)
    for name in sorted(count, key=count.get, reverse=True)[:12]:
        print(f"[profile] {name}: {count[name]} calls")
    ka = prof.key_averages()
    by_dev = ka.table(sort_by="self_device_time_total", row_limit=25)
    by_cpu = ka.table(sort_by="self_cpu_time_total", row_limit=25)
    if len(sys.argv) > 1:
        out = Path(sys.argv[1])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(f"{smi}\n\n# by device time\n{by_dev}\n\n# by host time\n{by_cpu}\n")
    print("\n".join(by_dev.splitlines()[:16]))
    print(f"[device] {smi}")


if __name__ == "__main__":
    main()
