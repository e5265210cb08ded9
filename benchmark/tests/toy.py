"""A copy of the benchmark with toy cells beside its own, for CPU tests."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# Toy cells at sizes a CPU test holds: the configurations' own values with
# smaller grids (the windy one at 64x64, the smallest of one CA update a
# step), a few envs and short episodes.
TOY = {
    "bulldozer-toy": ("bulldozer256", {"nrows": 64, "ncols": 64},
                      {"envs": 8, "actions": [[0, 9], [0, 2]], "check_envs": 5}),
    "advanced-toy": ("advanced256", {"nrows": 32, "ncols": 32},
                     {"envs": 4, "actions": [[0, 9], [0, 2], [0, 1]], "check_envs": 4}),
    # A sparse forest on a small grid, whose fires burn out (after 24 steps)
    # and whose envs auto-reset within an episode.
    "advanced-sparse": ("advanced256", {"nrows": 8, "ncols": 8, "p_tree": 0.05,
                                        "p_empty": 0.95},
                        {"envs": 6, "actions": [[0, 9], [0, 2], [0, 1]], "check_envs": 6,
                         "episode_steps": 60}),
}


def build(dest: Path) -> Path:
    """``dest`` holding BENCHMARK.json and benchmark/ plus the toy cells,
    each added as new files and new entries only."""
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "cache"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, (base, sizes, traffic) in TOY.items():
        entry = next(c for c in bench["configs"] if c["name"] == base)
        cfg = json.loads((ROOT / entry["file"]).read_text())
        cfg.update(sizes)
        (dest / "benchmark" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        (dest / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(
            dict(dict(kind="episodes", episode_steps=25, trace_from=5, trace_steps=3), **traffic)))
        bench["configs"].append(dict(entry, name=name, file=f"benchmark/configs/{name}.json"))
        cell = next(w for w in bench["workloads"] if w["config"] == base)
        bench["workloads"].append(dict(cell, name=name, config=name, traffic=name))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if cell["name"] in m.get("workloads", []):
                m["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest
