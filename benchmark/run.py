"""Run one benchmark cell of the PyTorch and CUDA port once.

    python3 benchmark/run.py --workload <config>.<mix> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Loads the cell's configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``, which
names its driver under ``drivers/``) and its correctness limits
(``limits/<cell>.json``), all found by name from ``BENCHMARK.json``; sets up
the system and warms it past every shape the mix uses; measures for
``--seconds``; judges what the timed path produced against the plain
reference (``reference.py``); prints one JSON line last on standard output.
With ``--trace 0`` the line holds the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, each computed by its own reader
(``metrics/<metric>.py``), the device's busy time and a breakdown.

Needs as many CUDA devices as the cell asks for; exits 2 without them. Exits
3, with no result, if JAX, Flax or the JAX package was loaded by the end.

A driver (``drivers/<name>.py``) defines ``Driver(ctx)`` with ``setup()``,
``window(seconds)``, ``end_to_end(wall)`` -> {metric: (value, unit)},
``counts()``, ``trace_stretch()``, ``record(wall)`` (what the per-layer
readers read), ``judge(control=False)`` -> {number: value},
``attempted_failed()`` and ``close()``. A new mix names an existing driver
in its data file; a new driver is a new file.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "voldor_tpu")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start_ticks / os.sysconf("SC_CLK_TCK")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of BENCHMARK.json with its pieces, found by name."""

    def __init__(self, root: Path, workload: str, bench: Path = BENCH):
        self.manifest = json.loads((root / "BENCHMARK.json").read_text())
        ws = {w["name"]: w for w in self.manifest["workloads"]}
        if workload not in ws:
            raise SystemExit(f"unknown workload {workload!r}; known: {sorted(ws)}")
        self.workload = ws[workload]
        self.name = workload
        cfg_entry = next(c for c in self.manifest["configs"] if c["name"] == self.workload["config"])
        self.config = json.loads((root / cfg_entry["file"]).read_text())
        self.traffic = json.loads((bench / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.limits = json.loads((bench / "limits" / f"{workload}.json").read_text())
        self.bench = bench
        self.driver_path = bench / "drivers" / f"{self.traffic['driver']}.py"
        e2e = [m for m in self.manifest["end_to_end"]
               if "workloads" not in m or workload in m["workloads"]]
        self.end_to_end = e2e
        names = {m["name"] for m in e2e}
        self.per_layer = [m for m in self.manifest["per_layer"]
                          if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]

    def driver(self, ctx):
        mod = load_module(self.driver_path, f"bench_driver_{self.traffic['driver'].replace('-', '_')}")
        return mod.Driver(ctx)

    def metric_reader(self, name: str):
        return load_module(self.bench / "metrics" / f"{name}.py", f"bench_metric_{name.replace('.', '_')}")


class Context:
    """What a driver is given: the cell, the seed, the device and the mode."""

    def __init__(self, cell: Cell, seed: int, device: str, trace: bool, torch):
        self.cell, self.seed, self.device, self.trace, self.torch = cell, seed, device, trace, torch
        self.config, self.traffic = cell.config, cell.traffic
        self.tmp = Path(tempfile.mkdtemp(prefix="bench-"))

    def sync(self):
        if self.device != "cpu":
            self.torch.cuda.synchronize()


def smi(fields: str) -> str:
    try:
        return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                              check=True, capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


class SmiSampler:
    """Clocks, power and temperature sampled beside the window."""

    FIELDS = "clocks.sm,clocks.mem,power.draw,temperature.gpu"

    def __init__(self, period_s: float = 2.0):
        self.samples, self._proc = [], None
        self.period_ms = int(period_s * 1000)

    def start(self):
        try:
            self._proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.FIELDS}", "--format=csv,noheader,nounits",
                 f"--loop-ms={self.period_ms}"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self._proc = None

    def stop(self):
        if self._proc is None:
            return
        self._proc.terminate()
        try:
            out, _ = self._proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            out, _ = self._proc.communicate()
        self.samples = [line.strip() for line in out.splitlines() if line.strip()]


class HostReading:
    """This process's CPU seconds over the window: set beside the same work
    in another run, it tells a slower host CPU from waiting on the card."""

    def __init__(self):
        self.a = (time.perf_counter(), resource.getrusage(resource.RUSAGE_SELF))

    def line(self) -> str:
        t, ru = time.perf_counter(), resource.getrusage(resource.RUSAGE_SELF)
        t0, ru0 = self.a
        return (f"process CPU s user {ru.ru_utime - ru0.ru_utime:.3f}, sys {ru.ru_stime - ru0.ru_stime:.3f} "
                f"over a wall of {t - t0:.3f} s; threads of this process {len(os.listdir('/proc/self/task'))}")


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda") -> dict:
    """One run of a cell; returns the result record (the last line)."""
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            log("no CUDA device: this benchmark measures the card and has no CPU fallback")
            raise SystemExit(2)
        if torch.cuda.device_count() < cell.workload["chips"]:
            log(f"the cell needs {cell.workload['chips']} CUDA devices; "
                f"{torch.cuda.device_count()} are visible")
            raise SystemExit(2)
        log(f"[device] {smi('name,power.limit,clocks.max.sm')}")
        torch.cuda.reset_peak_memory_stats()
    ctx = Context(cell, seed, device, trace, torch)
    drv = cell.driver(ctx)
    drv.setup()
    ctx.sync()
    setup_s = process_age_s()
    sampler = SmiSampler()
    if device == "cuda":
        sampler.start()
    host = HostReading()
    t0 = time.perf_counter()
    drv.window(seconds)
    ctx.sync()
    wall = time.perf_counter() - t0
    log(f"[host] {host.line()}")
    sampler.stop()
    peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
    for s in sampler.samples:
        log(f"[smi] clocks.sm MHz, clocks.mem MHz, power W, temperature C: {s}")
    e2e = drv.end_to_end(wall)
    e2e["setup_s"] = (setup_s, "s")
    for k, v in drv.counts().items():
        log(f"[counts] {k}: {v}")
    breakdown = prof = None
    if trace:
        prof = drv.trace_stretch()
        rec = drv.record(wall)
        rec["profile"] = prof
        log(f"[work] least seconds of the profiled layer calls: {prof.get('work')}; "
            f"device busy inside their spans: {prof.get('busy_in')}")
    numbers = drv.judge()
    import reference

    correct, rows = reference.verdict(numbers, cell.limits["numbers"])
    attempted, failed = drv.attempted_failed()
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = cell.metric_reader(m["name"]).value(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
            else:
                log(f"[metrics] {m['name']}: nothing to read in this run")
        if prof.get("device_ops"):
            breakdown = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]][0]), "unit": m["unit"]}
    if device == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": int(cell.workload["chips"]), "memory_peak_bytes": peak}
    else:
        dev = {"platform": "cpu", "kind": "CPU dry run: no measurement", "count": 0,
               "memory_peak_bytes": 0}
    if trace and prof.get("busy_s"):
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
    checks = {name: {"value": None if v is None else float(v), "limit": lim, "kind": kind}
              for name, v, lim, kind in rows}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if breakdown:
        out["breakdown"] = breakdown
    out["checks"] = checks
    drv.close()
    shutil.rmtree(ctx.tmp, ignore_errors=True)
    for name in sorted(set(numbers) - set(cell.limits["numbers"])):
        log(f"[reading] {name} = {numbers[name]!r} (reported, not compared)")
    for name, v, lim, kind in rows:
        log(f"[check] {name} = {v!r} ({'at most' if kind == 'max' else 'at least'} {lim})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = BENCH.parent
    # every build and kernel cache of the program inside the checkout, at a fixed path
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(root))
    cell = Cell(root, args.workload)
    out = run(cell, args.seed, args.seconds, bool(args.trace))
    # last, so that it sees every module the run loaded, the judging and the readers included
    bad = sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
    if bad:
        log(f"modules that the benchmark may not load were loaded: {bad}")
        raise SystemExit(3)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
