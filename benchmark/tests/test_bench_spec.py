"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
has the files the harness finds it by."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(LINE.match(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        for kind in ("envs", "reference"):
            assert (ROOT / "benchmark" / kind / f"{cfg['env']}.py").is_file()


def test_workloads():
    names = [w["name"] for w in BENCH["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(names)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4)
        traffic = json.loads((ROOT / "benchmark/traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark/traffic" / f"{traffic['kind']}.py").is_file()


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics(group):
    metrics = BENCH[group]
    all_names = [m["name"] for g in ("end_to_end", "per_layer") for m in BENCH[g]]
    assert len(set(all_names)) == len(all_names)
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in metrics:
        extra = {"bound"} if group == "end_to_end" else {"layer", "moves", "workloads"}
        assert METRIC_KEYS | extra <= set(m) <= METRIC_KEYS | extra | {"workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "benchmark/metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= cells
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
            assert LINE.match(m["layer"])
            assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
            if m["unit"] == "%" and "roofline" in m["name"]:
                assert m["name"].endswith("_roofline")
    if group == "end_to_end":
        assert "setup_s" in all_names and len(metrics) <= 16


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in BENCH["per_layer"] if w["name"] in m["workloads"]]
        assert layer and all(m["moves"] in e2e for m in layer)
