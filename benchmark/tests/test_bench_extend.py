"""A configuration, a traffic mix and a per-layer metric are added with new
files and new BENCHMARK.json entries alone: the harness finds each by name."""

import json
import shutil

from bench_support import BENCH, ROOT
import run


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    # a new configuration: a file of its own
    cfg = json.loads((bench / "configs" / "kitti-stereo.json").read_text())
    cfg.update(name="tum-rgbd", w=640, h=480)
    (bench / "configs" / "tum-rgbd.json").write_text(json.dumps(cfg))
    m["configs"].append({"name": "tum-rgbd", "source": "https://vision.in.tum.de/data/datasets/rgbd-dataset",
                         "file": "benchmark/configs/tum-rgbd.json", "reduced": [], "why": "a test"})
    # a new traffic mix: a data file naming an existing driver
    mix = json.loads((bench / "traffic" / "stream.json").read_text())
    mix.update(period=40)
    (bench / "traffic" / "long-period.json").write_text(json.dumps(mix))
    # the cell's limits, and a new per-layer metric with its reader
    (bench / "limits" / "tum-rgbd.long-period.json").write_text(
        (bench / "limits" / "kitti-stereo.stream.json").read_text())
    (bench / "metrics" / "windows_counted.py").write_text(
        'READS = ("program:vo_window",)\n\n\ndef value(rec):\n'
        '    n = sum(1 for e in rec.get("events", ()) if e.get("event") == "vo_window")\n'
        '    return n or None\n')
    m["workloads"].append({"name": "tum-rgbd.long-period", "config": "tum-rgbd",
                           "traffic": "long-period", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "windows_counted", "unit": "windows", "better": "higher",
                           "source": "program_counter", "layer": "SLAM VO layer (slam/system.py)",
                           "moves": "vo_fps", "workloads": ["tum-rgbd.long-period"]})
    m["end_to_end"][0]["workloads"].append("tum-rgbd.long-period")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    cell = run.Cell(tmp_path, "tum-rgbd.long-period", bench=bench)
    assert cell.config["w"] == 640 and cell.traffic["period"] == 40
    assert cell.driver_path == bench / "drivers" / "stream.py"
    assert [x["name"] for x in cell.per_layer] == ["windows_counted"]
    assert {x["name"] for x in cell.end_to_end} == {"vo_fps", "setup_s"}
    reader = cell.metric_reader("windows_counted")
    assert reader.value({"events": [{"event": "vo_window"}] * 3}) == 3
    assert reader.value({"events": []}) is None
    # no file that was there changed
    assert all((bench / p).read_bytes() == b for p, b in before.items())
    # the cells already there still resolve as before
    old = run.Cell(tmp_path, "kitti-stereo.stream", bench=bench)
    assert old.traffic["period"] == 24 and "windows_counted" not in {x["name"] for x in old.per_layer}
