"""Runs of the real cells on the card (``pytest -m gpu benchmark/tests``)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(cwd, cell, trace):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed",
                           str(2**31 + 17), "--seconds", "3", "--trace", str(trace)],
                          cwd=cwd, capture_output=True, text=True, timeout=360)


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell, trace):
    import torch

    out = _run(ROOT, cell, trace)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert r["device"]["kind"] == torch.cuda.get_device_name(0) and r["device"]["count"] == 1
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert all(0 < m["value"] <= 105 for k, m in r["metrics"].items() if "roofline" in k)


@pytest.mark.gpu
def test_without_the_program_there_is_no_result(card, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "cache"))
    out = _run(tmp_path, CELLS[0], 0)
    assert out.returncode != 0 and out.stdout == ""
