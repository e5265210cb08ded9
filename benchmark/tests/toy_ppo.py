"""A copy of the benchmark with a toy PPO cell beside its own, for CPU tests:
the trainer cell's configuration on a 32² grid with 2 envs, 8 rollout
steps, 2 minibatches and 2 epochs."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BASE, CELL = "advanced256-ppo", "advanced256-ppo-8"
SIZES = {"nrows": 32, "ncols": 32}
BATCH = {"envs": 2, "rollout_steps": 8, "minibatches": 2, "epochs": 2}


def config(**sizes) -> dict:
    """The trainer cell's configuration at the toy sizes."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == BASE)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    cfg.update(SIZES, **sizes)
    cfg["ppo"] = dict(cfg["ppo"], num_steps=BATCH["rollout_steps"],
                      num_minibatches=BATCH["minibatches"], update_epochs=BATCH["epochs"])
    return cfg


def build(dest: Path, name: str = "ppo-toy") -> Path:
    """``dest`` holding BENCHMARK.json and benchmark/ plus the toy cell
    ``name``, added as new files and new entries only."""
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "cache"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == BASE)
    (dest / "benchmark/configs" / f"{name}.json").write_text(json.dumps(config()))
    (dest / "benchmark/traffic" / f"{name}.json").write_text(
        json.dumps(dict(kind="ppo", **BATCH)))
    bench["configs"].append(dict(entry, name=name, file=f"benchmark/configs/{name}.json"))
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    bench["workloads"].append(dict(cell, name=name, config=name, traffic=name))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest
