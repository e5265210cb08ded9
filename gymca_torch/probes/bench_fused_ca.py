"""S6 on the card: the Alexandridis kernel alone, its ablations, and the
streaming floor of its bytes.

    python3 -m gymca_torch.probes.bench_fused_ca [--size 256] [--envs 64] [--steps 1000] [--tiled]

Counterpart of ``scripts/bench_fused_ca.py`` and its ``dma_floor``.  From
one reset of ``AdvancedForestFireBulldozerEnv(size, size, num_envs=envs)``
the kernel steps the grid and fire ages alone, the terrain and wind fixed,
``steps`` launches per repetition from the reset state, 3 repetitions; each
launch takes fresh seed words, drawn up front from a seeded generator.
Modes: ``fused`` (the step), ``fused+no-boxes``, ``fused+no-prng`` and
``fused+no-ignite`` (the kernel's ablation instances, each skipping one
phase) and ``dma-floor`` (``gymca_torch/csrc/dma_floor.cu``: the step's
bytes moved, nothing computed).  ``--tiled`` takes 8 envs at 512² (radius
7), the TPU's tiled sizes.  Prints one JSON line of device µs per launch
(the profiler's kernel events) and host µs per launch for each mode, with
the card's name.

The script's ``box_mode``s (``sat``, ``banded``, ``banded8``) have no
counterpart: they were TPU schedules for the box sums; the port's kernel
takes them from a summed-area table in shared memory in a tile with many
candidate cells and from the staged fire rows' popcounts in a sparse one.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from gymca_torch import rng
from gymca_torch.config import resolve_device
from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv
from gymca_torch.ops.alexandridis_kernel import alexandridis_fused_step
from gymca_torch.ops.stencil import NEIGHBOR_OFFSETS
from gymca_torch.probes import timing
from gymca_torch.probes.dma_floor_kernel import dma_floor

MODES = ("fused", "fused+no-boxes", "fused+no-prng", "fused+no-ignite", "dma-floor")
TILED_SIZE, TILED_ENVS = 512, 8
SEED = 1  # the seed words' generator


def reset_state(size, envs, device):
    """The kernel's inputs at one reset of the Advanced env, and its
    keywords: ``(grid, age, (dousing, vdf, exp_slope, wind_rows), kw)``."""
    env = AdvancedForestFireBulldozerEnv(size, size, key=rng.key(0, device=device),
                                         num_envs=envs, device=device)
    (_, ctx), _ = env.reset()
    pe, shared = ctx["per_env_context"], ctx["shared_context"]
    wm = shared["winds"][pe["wind_index"].long()]
    wind_rows = torch.stack([wm[:, 1 + dr, 1 + dc] for dr, dc in NEIGHBOR_OFFSETS],
                            dim=-1).contiguous()
    ca = env.ca
    kw = dict(empty=env._empty, tree=env._tree, fire=env._fire,
              layer_coeffs=env._layer_coeffs, dousing_border=float(ca._dousing_border),
              dousing_inner=float(ca._dousing_inner), fire_age_min=int(ca.fire_age_min),
              fire_age_max=int(ca.fire_age_max))
    consts = (pe["dousing_count"], pe["veg_den_factor"], pe["exp_slope"], wind_rows)
    return pe["true_grid"], pe["fire_age"], consts, kw


def run_mode(mode, grid, age, consts, seeds, kw):
    """``len(seeds)`` launches of ``mode``, carrying grid and age."""
    ablate = mode.partition("+no-")[2]
    for s in seeds:
        if mode == "dma-floor":
            grid, age, _ = dma_floor(grid, age, *consts, s)
        else:
            grid, age = alexandridis_fused_step(grid, age, *consts, s, ablate=ablate, **kw)
    return grid, age


def run(device=None, size=256, envs=64, steps=1000, reps=3) -> dict:
    """Run ``steps`` launches of each mode from one reset; on the card, time
    them.  Returns the result line as a dict (times None on the CPU)."""
    dev = resolve_device(device)
    grid, age, consts, kw = reset_state(size, envs, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    seeds = torch.randint(0, 2**32, (steps, envs, 2), generator=gen, device=dev,
                          dtype=torch.int64)
    out = {"size": size, "envs": envs, "steps": steps, "radius": len(kw["layer_coeffs"]),
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    for mode in MODES:
        def go(mode=mode):
            return run_mode(mode, grid, age, consts, seeds, kw)

        if dev.type != "cuda":
            go()
            out[f"{mode}_us"] = out[f"{mode}_host_us"] = None
            continue
        kernel = "dma_floor_kernel" if mode == "dma-floor" else "alexandridis_kernel"
        t = timing.time_launches(go, steps, kernel, reps)
        out[f"{mode}_us"], out[f"{mode}_host_us"] = t["device_us"], t["host_us"]
        print(f"[ca-bench] {mode}: {t['device_us']:.2f} us/launch device, "
              f"{t['host_us']:.2f} us/launch host ({envs * 1e6 / t['device_us']:,.0f} "
              f"env-steps/s of device time)", file=sys.stderr, flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--tiled", action="store_true",
                    help=f"{TILED_ENVS} envs at {TILED_SIZE}², the TPU's tiled sizes")
    a = ap.parse_args(argv)
    size, envs = (TILED_SIZE, TILED_ENVS) if a.tiled else (a.size, a.envs)
    dev = resolve_device()
    out = run(dev, size=size, envs=envs, steps=a.steps)
    out["card"] = timing.card()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
