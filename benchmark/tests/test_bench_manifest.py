"""BENCHMARK.json against the rules of its format (names, units, bounds,
the cells' metrics), and every piece it names present as a file of its own."""

import ast
import json
import re

import pytest

from bench_support import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
M = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(M["command"]) <= 32 and all(TEXT.match(w) for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/") and ".." not in p
    for w in M["command"]:
        assert not w.startswith("/") and ".." not in w
        if "/" in w:
            assert any(w.startswith(p + "/") for p in M["paths"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    # a full check at 24 cells fits into 43,200 s
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in M[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in M[k]}) == len(M[k])
    metrics = [x["name"] for x in M["end_to_end"] + M["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(r) for r in c["reduced"])
        assert not any(r.endswith(("_dim", "_rank")) for r in c["reduced"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"]) and NAME.match(w["traffic"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) == len(M["workloads"])
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(M["workloads"]) // 4)
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def _reported(workload):
    return {m["name"] for m in M["end_to_end"] if "workloads" not in m or workload in m["workloads"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in M["workloads"]:
        e2e = _reported(w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        per = [m for m in M["per_layer"] if w["name"] in m.get("workloads", [])
               or ("workloads" not in m and m["moves"] in e2e)]
        assert per, w["name"]


def test_moves_is_reported_wherever_the_per_layer_metric_is():
    e2e = {m["name"] for m in M["end_to_end"]}
    cells = {w["name"] for w in M["workloads"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for w in m.get("workloads", sorted(cells)):
            assert w in cells
            assert m["moves"] in _reported(w), (m["name"], w)


def test_every_piece_is_a_file_found_by_name():
    used = {w["config"] for w in M["workloads"]}
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    for c in M["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert all(r in cfg for r in c["reduced"])
    for w in M["workloads"]:
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        assert limits["numbers"] and all(v["kind"] in ("max", "min") for v in limits["numbers"].values())
    for m in M["per_layer"]:
        src = (BENCH / "metrics" / f"{m['name']}.py").read_text()
        fns = {n.name for n in ast.parse(src).body if isinstance(n, ast.FunctionDef)}
        assert "value" in fns and "READS" in src


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*")
                                        if p.is_file() and "__pycache__" not in p.parts))
def test_file_names_use_name_characters(path):
    assert re.match(r"^[A-Za-z0-9_./-]+$", path)
