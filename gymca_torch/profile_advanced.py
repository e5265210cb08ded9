"""Advanced-env step breakdown: ``scripts/profile_advanced.py`` on the port.

    python3 -m gymca_torch.profile_advanced [--envs 8] [--size 256] [--steps 1000]
    python3 -m gymca_torch.profile_advanced --envs 2 --size 32 --steps 5 --device-cpu

Times, per step, at ``--envs`` envs of ``--size``² (the script's
``ADV_ENVS``, 8, at 256², 1000 steps), from the reset of
``AdvancedForestFireBulldozerEnv(size, size, key=key(0), num_envs=envs,
use_fused_ca=True)``:

b) the Alexandridis kernel K2 alone, ``steps`` launches carrying the grid
   and the fire ages, on the reset's dousing, terrain factors and wind rows
   (``winds[wind_index]`` in ``NEIGHBOR_OFFSETS`` order), seeds ``[5, 9]``
   for every env, as the script;
c) the observation build alone: ``build_observation_on_extensions`` of the
   reset grid, positions ``(5, 7)``, zero actions;
a) the full ``stateless_step`` + ``conditional_reset`` on both CA paths:
   ``gymca_torch.bench_advanced.measure`` in this process (the script's
   own (a) only imports ``subprocess``).

Each line is the script's, with the device's own numbers beside it
(``probes.timing.time_steps``).  (b) adds K2's device µs per launch from
its kernel events (``probes.timing.time_launches``) beside its bound for
the inputs of the chain's first, middle and last launch
(``probes.kernel_inputs.k2_bound``).  Runs on the card; ``--device-cpu``
runs the plain versions on the CPU with the host clock only.
"""

from __future__ import annotations

import argparse
import sys

import torch

from gymca_torch import rng
from gymca_torch.config import resolve_device
from gymca_torch.ops.alexandridis_kernel import alexandridis_fused_step
from gymca_torch.ops.stencil import NEIGHBOR_OFFSETS
from gymca_torch.probes import kernel_inputs as ki
from gymca_torch.probes.timing import card, device_note, time_launches, time_steps

__all__ = ["parse_args", "make_env", "kernel_inputs", "run_kernel", "run_obs", "main"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Advanced-env step breakdown")
    ap.add_argument("--envs", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--device-cpu", action="store_true",
                    help="run on the CPU (plain versions, host clock only)")
    return ap.parse_args(argv)


def make_env(size: int, envs: int, device):
    """The script's env: fused CA, key(0)."""
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv

    return AdvancedForestFireBulldozerEnv(size, size, key=rng.key(0, device=device),
                                          num_envs=envs, use_fused_ca=True, device=device)


def kernel_inputs(env, obs):
    """K2's inputs from a reset, as the script builds them: ``(x, kw)``, ``x``
    the kernel's tensors by name (seeds ``[5, 9]`` for every env)."""
    per_env = obs[1]["per_env_context"]
    shared = obs[1]["shared_context"]
    wm = shared["winds"][per_env["wind_index"].long()]
    wind_rows = torch.stack([wm[:, 1 + dr, 1 + dc] for dr, dc in NEIGHBOR_OFFSETS], dim=-1)
    n = wind_rows.shape[0]
    seeds = torch.tensor([[5, 9]], dtype=torch.int64, device=wind_rows.device).repeat(n, 1)
    x = dict(grid=per_env["true_grid"], fire_age=per_env["fire_age"],
             dousing=per_env["dousing_count"], vdf=per_env["veg_den_factor"],
             exp_slope=per_env["exp_slope"], wind_rows=wind_rows, seeds=seeds)
    return x, ki.alexandridis_keywords(env.ca)


def run_kernel(x, kw, steps: int):
    """``steps`` launches of K2 carrying grid and age from ``x``: the last
    ``(grid, fire_age)``."""
    grid, age = x["grid"], x["fire_age"]
    for _ in range(steps):
        grid, age = alexandridis_fused_step(
            grid, age, x["dousing"], x["vdf"], x["exp_slope"], x["wind_rows"], x["seeds"],
            **kw)
    return grid, age


def run_obs(env, obs, steps: int):
    """``steps`` observation builds of the reset grid: the last ``rgb``."""
    per_env = obs[1]["per_env_context"]
    shared = obs[1]["shared_context"]
    grid = per_env["true_grid"]
    n = grid.shape[0]
    acts = torch.zeros((n, 3), dtype=torch.int32, device=grid.device)
    positions = torch.tensor([[5, 7]], dtype=torch.int32, device=grid.device).repeat(n, 1)
    for _ in range(steps):
        rgb, _ = env.build_observation_on_extensions(grid, positions, acts, per_env, shared)
    return rgb


def main(argv=None) -> dict:
    """The breakdown: prints the script's lines with the device's numbers
    and returns each part's numbers by name."""
    from gymca_torch.bench_advanced import measure, report

    a = parse_args(argv)
    dev = resolve_device("cpu" if a.device_cpu else None)
    on_card = dev.type == "cuda"
    smi = card() if on_card else None
    n, steps = a.envs, a.steps
    print(f"[profile_advanced] {n} envs x {a.size}x{a.size}, {steps} steps, "
          f"{smi or 'cpu (plain versions)'}", flush=True)
    env = make_env(a.size, n, dev)
    obs, _ = env.reset()
    out = {}

    # (b) the fused kernel alone
    x, kw = kernel_inputs(env, obs)
    t = time_steps(lambda k: run_kernel(x, kw, k), steps, f"K2 alone, {n} x {a.size}²", dev,
                   card=smi, trace_steps=steps)
    line = (f"fused CA kernel alone: {t['host_us']:7.1f} us/step "
            f"({t['host_us'] / n:.2f} us/env)  | {device_note(t)}")
    if on_card:
        launches = time_launches(lambda: run_kernel(x, kw, steps), steps, "alexandridis_kernel")
        with ki.alexandridis_recorder({0, steps // 2, steps - 1},
                                      sys.modules[__name__]) as rec:
            run_kernel(x, kw, steps)
        b = ki.k2_bound(rec)
        us = launches["device_us"]
        t.update(k2_device_us=us, k2_bound_us=b["bound_ms"] * 1e3, k2_bound_by=b["by"],
                 k2_dense_bound_us=b["dense_ms"] * 1e3)
        line += (f"; K2 device {us:.2f} us/launch, bound {b['bound_ms'] * 1e3:.2f} us by "
                 f"{b['by']} ({b['bound_ms'] * 1e3 / us:.0%} of it), dense bound "
                 f"{b['dense_ms'] * 1e3:.2f} us")
    out["kernel"] = t
    print(line, flush=True)

    # (c) the observation build alone
    t = time_steps(lambda k: run_obs(env, obs, k), steps, f"obs build, {n} x {a.size}²",
                   dev, card=smi)
    out["obs"] = t
    print(f"obs pipeline alone:    {t['host_us']:7.1f} us/step  | {device_note(t)}", flush=True)

    # (a) the full step on both paths, in this process
    for use_fused in (False, True):
        r = measure(use_fused, n, a.size, steps, dev, smi)
        out["full " + ("fused Pallas CA" if use_fused else "XLA CA")] = r
        report(a.size, n, r)
    return out


if __name__ == "__main__":
    main()
