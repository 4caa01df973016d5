"""A tiny dry run of the stream driver on the CPU, through the port's plain
kernel versions: the whole run with its result line, labelled as no
measurement. The harness's look for a card is skipped (``device="cpu"``)."""

import json
from pathlib import Path

from bench_support import BENCH, TINY_CONFIG, one_thread, tiny, tiny_root  # noqa: F401 (fixtures)
import run


def _run(root, workload, seconds, trace):
    cell = run.Cell(root, workload, bench=BENCH)
    return cell, run.run(cell, 2 ** 31 + 987654321, seconds, trace, device="cpu")


def _common(out):
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "cpu" and "no measurement" in out["device"]["kind"]
    json.dumps(out)


def test_stream_dry_run(tiny, one_thread):
    cell, out = _run(tiny, "kitti-stereo.stream", 3.0, False)
    _common(out)
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {"vo_fps", "vo_step_p95_ms", "setup_s"}
    assert set(out["checks"]) == set(cell.limits["numbers"])


def test_stream_traced_dry_run_reads_the_host_side_metrics(tiny, one_thread):
    _, out = _run(tiny, "kitti-stereo.stream", 2.0, True)
    _common(out)
    # spans, program events and the engine's counter are read on the CPU;
    # the device's busy time and the rooflines need the card's trace
    assert {"vo_window_ms_p50", "em_iters_per_window", "pose_sweep_share",
            "depth_round_share"} <= set(out["metrics"])
    assert not {"cost_roofline", "pose_roofline", "device_idle.vo"} & set(out["metrics"])
    assert "busy_s" not in out["device"] and "breakdown" not in out



def test_the_stream_driver_runs_a_monocular_configuration(tmp_path, one_thread):
    """The driver's monocular branch (no disparity, depth judged at the
    scale of the keyframe's own step, no metric translation), which a mono
    cell added as data files alone would run."""
    import shutil

    import torch

    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    root = tiny_root(tmp_path, 96, 32, TINY_CONFIG)
    m = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads(Path(m["configs"][0]["file"]).read_text())
    cfg.update(name="mono-test", mode="mono")
    del cfg["bf"]
    (tmp_path / "mono-test.json").write_text(json.dumps(cfg))
    m["configs"].append(dict(m["configs"][0], name="mono-test", file=str(tmp_path / "mono-test.json")))
    m["workloads"].append(dict(m["workloads"][0], name="mono-test.stream", config="mono-test"))
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    (bench / "limits" / "mono-test.stream.json").write_text(
        json.dumps({"numbers": {"keyframes_judged": {"kind": "min", "limit": 1}}}))
    cell = run.Cell(root, "mono-test.stream", bench=bench)
    ctx = run.Context(cell, 2 ** 31 + 7, "cpu", False, torch)
    drv = cell.driver(ctx)
    drv.setup()
    drv.window(3.0)
    program, control = drv.judge(), drv.judge(control=True)
    drv.close()
    assert "t_err" not in program and program["keyframes_judged"] >= 1
    assert program["tdir_err_deg"] < 5 and control["tdir_err_deg"] > 90
    assert program["depth_shape_err"] < 0.05
