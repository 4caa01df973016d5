"""On the card only (marked ``gpu``; skipped where there is no CUDA
device): a short run of each cell is correct and names the card, and the
control, at the cell's own size on three seeds, is not correct."""

import json
import subprocess
import sys

import pytest

from bench_support import ROOT, card  # noqa: F401 (card is a fixture)

pytestmark = pytest.mark.gpu
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_is_correct_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
                          "4000000007", "--seconds", "8", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu" and res["device"]["count"] == 1


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_own_size(card, workload):
    import reference
    import run
    import torch

    cell = run.Cell(ROOT, workload)
    for seed in (5000000029, 5000000039, 5000000051):
        ctx = run.Context(cell, seed, "cuda", False, torch)
        drv = cell.driver(ctx)
        drv.setup()
        drv.window(10.0)
        ok, _ = reference.verdict(drv.judge(), cell.limits["numbers"])
        bad, rows = reference.verdict(drv.judge(control=True), cell.limits["numbers"])
        drv.close()
        assert ok and not bad, (seed, rows)
