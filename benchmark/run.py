"""One run of one cell of the benchmark of ``gymca_torch`` on NVIDIA cards.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout.  ``BENCHMARK.json`` names the cell: its
configuration (``benchmark/configs/<config>.json``, whose ``env`` names the
system's adapter ``benchmark/envs/<env>.py`` and its plain reference
``benchmark/reference/<env>.py``), its traffic (``benchmark/traffic/
<traffic>.json``, whose ``kind`` names the generator and driving loop
``benchmark/traffic/<kind>.py``) and the metrics it reports, each read by
``benchmark/metrics/<metric>.py``.  A later cell, configuration, traffic mix,
traffic kind or metric is new files and new entries.

A run builds the system from the seed, warms up the cell's shapes (the
set-up, ``setup_s``), drives it for ``--seconds`` and then, with the window
closed and the device's peak memory read, has the traffic's driver compare
the program's answers with the reference's.  ``--trace 0`` reports the
end-to-end metrics; ``--trace 1`` profiles a fixed part of an episode after
the window and reports the per-layer metrics, the device's busy time and a
breakdown.  The last line of stdout is the result; the last lines of stderr
are the compared numbers beside their limits.  Without enough CUDA cards,
or with JAX or the JAX package loaded, it prints no result and exits
non-zero.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gymca_tpu"})


def setup_seconds() -> float:
    """Seconds since this process started, from Linux's /proc: at the
    window's start, the set-up's."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")  # field 22, starttime


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spec:
    """``BENCHMARK.json`` under ``root`` and the files it names."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        entry = next(c for c in self.bench["configs"] if c["name"] == cell["config"])
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, cell: dict) -> dict:
        return json.loads((self.root / "benchmark" / "traffic" / f"{cell['traffic']}.json")
                          .read_text())

    def metrics(self, cell: dict, trace: bool) -> list:
        """The metrics the cell reports: the end-to-end ones, or with a trace
        the per-layer ones; each per-layer metric lists its cells."""
        if not trace:
            return [m for m in self.bench["end_to_end"]
                    if cell["name"] in m.get("workloads", [cell["name"]])]
        return [m for m in self.bench["per_layer"] if cell["name"] in m["workloads"]]

    def module(self, kind: str, name: str):
        return _load(self.root / "benchmark" / kind / f"{name}.py", f"benchmark_{kind}_{name}")


def _power_limit(index: int):
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              f"--id={index}"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def log(*parts):
    print("[benchmark]", *parts, file=sys.stderr, flush=True)


def _builds() -> set:
    """The program's built kernel libraries: a run that adds one built it."""
    from gymca_torch._build import BUILD_DIR

    return set(BUILD_DIR.glob("*.so"))


def run_cell(spec: Spec, name: str, seed: int, seconds: float, trace: bool, device,
             max_steps=None):
    """The result of one run of cell ``name`` on ``device``."""
    import torch

    cell = spec.cell(name)
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    built = _builds()
    log(f"set-up: imports done at {setup_seconds():.3f} s")
    system = spec.module("envs", cfg["env"]).System(cfg, traffic["envs"], seed, dev)
    log(f"set-up: system built at {setup_seconds():.3f} s")
    loop = spec.module("traffic", traffic["kind"]).Driver(system, traffic, seed, dev, trace)
    del system  # the driver holds it, and frees it for the check
    loop.warm()
    setup_s = setup_seconds()
    built = sorted(p.name for p in _builds() - built)
    log(f"set-up: {setup_s:.3f} s; kernels built by this run: {', '.join(built) or 'none'}")
    rec = loop.window(seconds, max_steps)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    rec.update(setup_s=setup_s, config=cfg, traffic=traffic)
    log(f"{name} seed {seed}: {rec['attempted']} attempted; peak {peak} bytes")

    metrics = {}
    for m in spec.metrics(cell, trace):
        value = spec.module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": False, "attempted": rec["attempted"], "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                         "count": cell["chips"], "memory_peak_bytes": peak,
                         "power_limit": _power_limit(dev.index or 0) if cuda else None}}
    if rec["trace"] is not None:
        result["device"].update(busy_s=rec["trace"].busy_s, window_s=rec["trace"].window_s)
        result["breakdown"] = rec["trace"].breakdown()
    # A checkout's first run builds the kernels with nvcc inside its set-up.
    result["cold_build"] = bool(built)

    del rec  # the traced steps' inputs hold device state
    ref = spec.module("reference", cfg["env"])
    numbers = loop.check(ref)
    result["correct"] = all(v <= ref.LIMITS[k] for k, v in numbers.items())  # NaN fails
    result["checks"] = {k: {"value": v, "limit": ref.LIMITS[k]} for k, v in numbers.items()}
    return result


def forbidden_modules():
    """JAX or the JAX package among the loaded modules, by top-level name."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cache = ROOT / "benchmark" / "cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")

    import torch

    import gymca_torch

    if ROOT not in Path(gymca_torch.__file__).resolve().parents:
        print(f"benchmark: gymca_torch comes from {gymca_torch.__file__}, not from the "
              f"checkout {ROOT}", file=sys.stderr)
        return 2
    spec = Spec(ROOT)
    cell = spec.cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {a.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run_cell(spec, a.workload, a.seed, a.seconds, bool(a.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
