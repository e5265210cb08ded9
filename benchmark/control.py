"""The control of a cell's check, on the card.

    python3 -m benchmark.control --workload NAME --seeds 11 12 13

The control is the reference put in the program's place and computed in the
nearest precision below the configuration's (bfloat16 for its float32
parts).  For each seed it makes the cell's inputs as a run makes them (the
reset from the seed, the first episode's actions from the seed's
generator), steps the control over the whole batch for one episode, the
reference over the run's sample of envs, and prints the cell's compared
numbers, one JSON line a seed; the last line holds the least reading of
each number over the seeds, the upper reading a limit must stay below.  No
program runs, so nothing of it is imported.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from benchmark.run import ROOT, Spec


def readings(spec: Spec, name: str, seed: int, device) -> dict:
    cell = spec.cell(name)
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    n, steps = traffic["envs"], traffic["episode_steps"]
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    drive = spec.module("traffic", traffic["kind"])
    actions = drive.draw_actions(gen, traffic, dev)
    inputs = spec.module("envs", cfg["env"]).inputs(cfg, n, seed, dev)
    ref = spec.module("reference", cfg["env"])
    idx = drive.sample_envs(seed, n, traffic["check_envs"])
    t0 = time.perf_counter()
    start, end = ref.replay(cfg, seed, n, idx, actions, dev, **inputs)
    t1 = time.perf_counter()
    every = torch.arange(n)
    low_start, low_end = ref.replay(cfg, seed, n, every, actions, dev, low=True, **inputs)
    pick = idx.to(dev)
    numbers = ref.check({k: v[pick] for k, v in low_start.items()}, start,
                        {k: v[pick] for k, v in low_end.items()}, end)
    return {"seed": seed, "steps": steps, "envs": n, "reference_s": t1 - t0,
            "control_s": time.perf_counter() - t1, "numbers": numbers}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    spec = Spec(ROOT)
    least = None
    for seed in a.seeds:
        r = readings(spec, a.workload, seed, "cuda")
        print(json.dumps(r), flush=True)
        least = dict(r["numbers"]) if least is None else {
            k: min(v, r["numbers"][k]) for k, v in least.items()}
    print(json.dumps({"workload": a.workload, "least": least}), flush=True)


if __name__ == "__main__":
    main()
