"""S4 on the card: four formulations of the dense windy-CA step, timed.

    python3 -m gymca_torch.probes.exp_ca_variants

Counterpart of ``scripts/exp_ca_variants.py`` at its sizes: 256 envs of
256 x 256 int8 cells drawn EMPTY, TREE, FIRE with p = (0.098, 0.9, 0.002),
gusts on with p = 0.6, 40 in-place steps per repetition, 3 repetitions.  Prints
ns per grid and µs per step for each formulation (banded int32, boolean,
float32 FMA, SWAR; ``gymca_torch/csrc/ca_variants.cu``), device time from
the profiler's kernel events and host time to a synchronize, then checks the
four against each other and against ``windy_step_from_success`` over the 40
steps, as the script does.
"""

from __future__ import annotations

import argparse
from typing import List

import torch

from gymca_torch.config import resolve_device
from gymca_torch.ops.windy import PROPAGATION
from gymca_torch.probes import timing
from gymca_torch.probes.ca_variants_kernel import (
    EMPTY,
    FIRE,
    KERNEL_NAMES,
    TREE,
    VARIANTS,
    ca_variant_step,
    reference_step,
)

N, H, W = 256, 256, 256
STEPS = 40
P_CELLS = (0.098, 0.9, 0.002)  # EMPTY, TREE, FIRE
P_GUST = 0.6
SEED = 0
LABELS = {"banded": "A banded int32", "bool": "B boolean", "fma": "C f32-FMA banded",
          "swar": "D int8 packed-u32 SWAR"}


def make_inputs(n, h, w, seed, device):
    """The grid and gusts from a seeded ``torch.Generator`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand((n, h, w), generator=gen, device=device)
    grid = torch.where(u < P_CELLS[0], EMPTY,
                       torch.where(u < P_CELLS[0] + P_CELLS[1], TREE, FIRE)).to(torch.int8)
    gusts = torch.rand((n, 8), generator=gen, device=device) < P_GUST
    return grid, (gusts.to(torch.int32) * PROPAGATION).contiguous()


def run_steps(step, grid, weights, steps):
    counts = None
    for _ in range(steps):
        grid, counts = step(grid, weights)
    return grid, counts


def run(device=None, n=N, h=H, w=W, steps=STEPS, reps=3) -> List[dict]:
    """Time each formulation (on the card; on the CPU the plain versions run
    and nothing is timed) and check that all give the reference's grid and
    counts after ``steps`` steps.  Returns one row per formulation."""
    dev = resolve_device(device)
    grid0, weights = make_inputs(n, h, w, SEED, dev)
    want = run_steps(reference_step, grid0.clone(), weights, steps)
    rows = []
    for v in VARIANTS:
        g = grid0.clone()

        def step(grid, wts, v=v):
            return ca_variant_step(v, grid, wts)

        row = {"variant": v, "device_us": None, "host_us": None}
        if dev.type == "cuda":
            row.update(timing.time_launches(lambda: run_steps(step, g, weights, steps), steps,
                                            KERNEL_NAMES[v], reps,
                                            reset=lambda: g.copy_(grid0)))
        g.copy_(grid0)
        got = run_steps(step, g, weights, steps)
        row["equal"] = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        rows.append(row)
    bad = [r["variant"] for r in rows if not r["equal"]]
    if bad:
        raise RuntimeError(f"formulations {bad} differ from the reference after {steps} steps")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    a = ap.parse_args(argv)
    dev = resolve_device()
    print(f"[device] {timing.card()}", flush=True)
    rows = run(dev, steps=a.steps)
    for r in rows:
        print(f"{LABELS[r['variant']]:24s}: {r['device_us'] * 1e3 / N:8.1f} ns/grid "
              f"({r['device_us']:7.2f} us/step device, {r['host_us']:7.2f} us/step host)",
              flush=True)
    print(f"parity A == B == C == D == windy_step_from_success over {a.steps} steps OK")


if __name__ == "__main__":
    main()
