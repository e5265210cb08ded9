"""The control of a trainer cell's check, on the card.

    python3 -m benchmark.control_ppo --workload NAME --seeds 11 12 13

The control is the plain reference of ``benchmark/reference/ppo.py`` in
bfloat16, in the program's place: for each seed it makes the run's reset
and terrain, draws params of the configuration's shapes and init from the
seed, runs one iteration of the traffic's batch in bfloat16
(``control_record``: the policy's Gumbel draws, the env's ``low`` step,
GAE, every minibatch's loss, gradients, clip and Adam) and has the check
read that record as it reads the program's.  It prints the compared
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
    dev = torch.device(device)
    n = traffic["envs"]
    terrain = spec.module("envs", cfg["env"]).inputs(cfg, n, seed, dev)["terrain"]
    ref = spec.module("reference", cfg["env"])
    t0 = time.perf_counter()
    record = ref.control_record(cfg, seed, n, terrain, dev)
    t1 = time.perf_counter()
    numbers = ref.check(cfg, record, terrain, dev)
    return {"seed": seed, "envs": n, "control_s": t1 - t0,
            "reference_s": time.perf_counter() - t1, "numbers": numbers}


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
