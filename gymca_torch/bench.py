"""Headline benchmark: aggregate env-steps/s on ForestFireBulldozer256x256.

``bench.py`` on the port:

    python3 -m gymca_torch.bench                           # on the card
    python3 -m gymca_torch.bench --smoke --device-cpu      # tiny, on the CPU

Prints bench.py's two JSON lines on stdout, the headline last:

    {"metric": "advanced256_env_steps_per_sec", ...}    # the Advanced physics
    {"metric": "bulldozer256_env_steps_per_sec", ...}   # the headline

* the headline: random-policy env-steps/s of ``BulldozerCore(size,
  size).step_batched`` over ``GYMCA_BENCH_ENVS`` envs (kernel K1 on the
  card, its plain version on the CPU), states from ``initial_state(split(
  key(0), n))``; each step's actions are bench.py:100-104's, ``key, k_act =
  split(key)``, ``randint(k_act, (n, 2), 0, 2)`` with column 0 from
  ``randint(fold_in(k_act, 1), (n,), 0, 9)``, and each step's reward is
  summed;
* the Advanced value: ``AdvancedForestFireBulldozerEnv(size, size,
  key=key(0), num_envs=GYMCA_BENCH_ADV_ENVS, use_fused_ca=not smoke)`` (the
  Alexandridis kernel K2 on the card), ``stateless_step`` then
  ``conditional_reset``, through ``gymca_torch.bench_advanced.run``;
* ``vs_baseline``: against the reference's architecture on this host (one
  scipy-convolution env stepped in a Python loop, bench.py:198-250, kept
  here as :func:`measure_reference_style_numpy`), or
  ``GYMCA_BENCH_BASELINE_SPS``; for the Advanced value only
  ``GYMCA_BENCH_ADV_BASELINE_SPS``, and ``null`` when it is unset
  (bench.py's default of 23.9 was measured on another device).

Each metric is the best of 3 runs after 2 untimed ones (bench.py's keys:
the windy runs from ``key``, ``fold_in(key, 1)``, then ``fold_in(key, 2 +
i)``; the Advanced ones from ``key(1)``, ``key(2)``, then ``key(3 + i)``),
every run from the same reset states: ``step_batched`` writes grids in
place, so the windy states are cloned before each run, outside the clock.
Each run's actions are drawn in bulk before its clock starts (bench.py
draws them inside its jitted scan), the env's own key chain stays inside.
On a card the steps run under ``torch.cuda.set_sync_debug_mode("error")``;
a run's clock ends on a fetch of its last reward sum and a synchronize.

stderr carries the card's name and power limit, the path taken, the
draws' seconds, every rep and the done fraction.  Knobs: bench.py's
``GYMCA_BENCH_SIZE``, ``_ENVS``, ``_STEPS``, ``_ADV=0``, ``_ADV_ENVS``,
``_BASELINE_SPS``, ``_ADV_BASELINE_SPS`` and ``--smoke``; ``--device-cpu``
runs on the CPU, which without it is refused.  ``GYMCA_BENCH_STENCIL``
takes only ``auto``: K1 has one formulation.  bench.py's sharded branch is
not ported: with several cards the bench steps on the current one.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from gymca_torch import rng
from gymca_torch.bench_advanced import run as advanced_run
from gymca_torch.config import resolve_device
from gymca_torch.probes.timing import card, sync_errors

__all__ = ["windy_actions", "windy_run", "measure_windy", "measure_advanced",
           "measure_reference_style_numpy", "parse_args", "main"]

WARM, REPS = 2, 3  # untimed runs, then timed runs of which the best counts


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def windy_actions(key, steps: int, n: int):
    """bench.py:100-104's actions for ``steps`` steps of ``n`` envs from
    ``key``: ``(steps, n, 2)`` int32."""
    k_acts = []
    for _ in range(steps):
        pair = rng.split(key)
        key = pair[0]
        k_acts.append(pair[1])
    k_acts = torch.stack(k_acts)
    actions = rng.randint(k_acts, (n, 2), 0, 2)
    actions[..., 0] = rng.randint(rng.fold_in(k_acts, 1), (n,), 0, 9)
    return actions


def windy_run(core, reset_states, key, steps: int) -> dict:
    """One windy run of ``steps`` steps of ``core.step_batched`` from a clone
    of ``reset_states`` with the actions of :func:`windy_actions` from
    ``key``, both made before the clock starts.  Returns ``seconds``,
    ``draw_seconds``, the end ``states`` and ``reward_sums`` (each step's
    reward summed over the envs)."""
    dev = reset_states.grid.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    actions = windy_actions(key, steps, reset_states.grid.shape[0])
    states = reset_states.clone()
    sync()
    t1 = time.perf_counter()
    sums = []
    with sync_errors(dev):
        for a in actions:
            states, out = core.step_batched(states, a)
            sums.append(out.reward.sum())
    float(sums[-1])
    sync()
    t2 = time.perf_counter()
    return {"seconds": t2 - t1, "draw_seconds": t1 - t0, "states": states,
            "reward_sums": torch.stack(sums)}


def _report_reps(label, drawn, runs, envs, steps, kernel, launches, path):
    log(f"[bench] {label}outside each run's clock, {drawn}: "
        + ", ".join(f"{r['draw_seconds']:.3f}" for r in runs) + " s")
    log(f"[bench] {label}{kernel} launches in the {len(runs)} runs: {launches} ({path})")
    for i, r in enumerate(runs[WARM:]):
        dt = r["seconds"]
        log(f"[bench] {label}rep {i}: {dt * 1e3:.1f} ms ({envs * steps / dt:,.0f} steps/s)")


def measure_windy(size: int, num_envs: int, steps: int, device) -> dict:
    """bench.py's ``measure_tpu_native``: ``value``, env-steps/s of the best
    of ``REPS`` runs after ``WARM``, with every run (``runs``, each
    :func:`windy_run`'s dict, the end ``states`` kept for the last run only),
    the done fraction after the last, the path taken and K1's ``launches``."""
    from gymca_torch.envs.bulldozer import BulldozerCore
    from gymca_torch.ops.windy_kernel import windy_fused_step

    dev = torch.device(device)
    core = BulldozerCore(size, size, device=dev)
    key = rng.key(0, device=dev)
    reset_states = core.initial_state(rng.split(key, num_envs))
    path = ("windy kernel K1" if dev.type == "cuda" else "K1's plain version") \
        if core.supports_fused_step() else "eager step (several CA periods a step)"
    log(f"[bench] path=step_batched, {path}, grid_dtype={core._grid_dtype} size={size} "
        f"envs={num_envs} steps={steps}")
    keys = [key, rng.fold_in(key, 1)] + [rng.fold_in(key, 2 + i) for i in range(REPS)]
    before = windy_fused_step.launches
    t0 = time.perf_counter()
    runs = [windy_run(core, reset_states, keys[0], steps)]
    log(f"[bench] first run: {time.perf_counter() - t0:.1f}s")
    runs += [windy_run(core, reset_states, k, steps) for k in keys[1:]]
    for r in runs[:-1]:
        del r["states"]  # a grid as large as the batch's, each
    launches = windy_fused_step.launches - before
    _report_reps("", "its actions drawn for every step and the reset states cloned", runs,
                 num_envs, steps, "K1", launches, path)
    done = float(runs[-1]["states"].done.float().mean())
    log(f"[bench] done fraction after {steps} steps: {done:.3f}")
    best = min(r["seconds"] for r in runs[WARM:])
    return {"value": num_envs * steps / best, "runs": runs, "done_fraction": done,
            "path": path, "launches": launches}


def measure_advanced(size: int, num_envs: int, steps: int, device,
                     smoke: bool = False) -> dict:
    """bench.py's ``measure_advanced``: ``value``, env-steps/s of the best of
    ``REPS`` runs after ``WARM`` (``gymca_torch.bench_advanced.run``), every
    run, the share of envs that terminated at the last step of the last run,
    the path taken and K2's ``launches``."""
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv
    from gymca_torch.ops.alexandridis_kernel import alexandridis_fused_step

    dev = torch.device(device)
    env = AdvancedForestFireBulldozerEnv(size, size, key=rng.key(0, device=dev),
                                         num_envs=num_envs, use_fused_ca=not smoke, device=dev)
    path = ("Alexandridis kernel K2" if dev.type == "cuda" else "K2's plain version") \
        if env.use_fused_ca else "XLA-path counterpart"
    log(f"[bench] advanced path={path} size={size} envs={num_envs} steps={steps}")
    obs, info = env.reset()
    before = alexandridis_fused_step.launches
    t0 = time.perf_counter()
    runs = [advanced_run(env, obs, info, 1, steps)]
    log(f"[bench] advanced first run: {time.perf_counter() - t0:.1f}s")
    runs += [advanced_run(env, obs, info, seed, steps) for seed in range(2, 1 + WARM + REPS)]
    launches = alexandridis_fused_step.launches - before
    _report_reps("advanced ", "its actions drawn for every step", runs, num_envs, steps, "K2",
                 launches, path)
    done = float(runs[-1]["terminated"].float().mean())
    log(f"[bench] advanced done fraction at step {steps} (before its conditional reset): "
        f"{done:.3f}")
    best = min(r["seconds"] for r in runs[WARM:])
    return {"value": num_envs * steps / best, "runs": runs, "done_fraction": done,
            "path": path, "launches": launches}


def measure_reference_style_numpy(size: int, seconds: float = 3.0) -> float:
    """Reference-architecture baseline (bench.py:198-250): single env, scipy
    conv + decode per CA update, RepeatCA timing semantics (most steps run
    zero CA updates)."""
    from scipy.signal import convolve2d

    gen = np.random.default_rng(0)
    empty, tree, fire = 0, 3, 25
    identity, propagation = 2**11, 2**3
    grid = gen.choice([empty, tree, fire], size=(size, size),
                      p=[0.099, 0.9, 0.001]).astype(np.int64)
    wind = np.clip(gen.random((3, 3)), 0.05, 1.0)
    keep_b = identity * tree
    prop_b = identity * tree + propagation * fire
    cons_b = identity * fire

    scale = size
    t_any = 0.001
    t_move = 1 / (0.12 * scale) - t_any
    t_shoot = 1 / (0.03 * scale) - t_move
    accu = 0.0
    pos = np.array([size // 4, 3 * size // 4])

    def ca_step(grid):
        roll = gen.random((3, 3))
        kernel = np.where(wind > roll, propagation, empty)
        kernel[1, 1] = identity
        signal = convolve2d(grid, kernel, mode="same", boundary="fill", fillvalue=empty)
        new = np.full_like(grid, empty)
        new[(signal >= keep_b) & (signal < prop_b)] = tree
        new[(signal >= prop_b) & (signal < cons_b)] = fire
        new[signal >= cons_b] = empty
        return new

    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        move, shoot = gen.integers(0, 9), gen.integers(0, 2)
        accu += (t_move if move != 4 else 0.0) + (t_shoot if shoot else 0.0) + t_any
        frac, repeats = math.modf(accu)
        accu = frac
        for _ in range(int(repeats)):
            grid = ca_step(grid)
        # move/modify + reward bookkeeping
        pos = np.clip(pos + gen.integers(-1, 2, 2), 0, size - 1)
        if shoot and grid[pos[0], pos[1]] == tree:
            grid[pos[0], pos[1]] = empty
        t = (grid == tree).sum()
        f = (grid == fire).sum()
        _ = -(f / max(t + f, 1))
        n += 1
    return n / (time.perf_counter() - t0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="bench.py's smoke sizes: 64 envs at 64², 10 steps; 8 Advanced envs")
    ap.add_argument("--device-cpu", action="store_true",
                    help="run on the CPU (plain versions, host clock only)")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """bench.py's ``main``: prints its two JSON lines and returns them."""
    a = parse_args(argv)
    stencil = os.environ.get("GYMCA_BENCH_STENCIL", "auto")
    if stencil != "auto":
        raise ValueError(
            f"GYMCA_BENCH_STENCIL={stencil!r}: K1 has one formulation, so only 'auto' is "
            f"taken; the windy CA's formulations are compared by S4, python3 -m "
            f"gymca_torch.probes.exp_ca_variants")
    dev = resolve_device("cpu" if a.device_cpu else None)
    if dev.type == "cuda":
        log(f"[bench] device={card()} (nvidia-smi name, power limit)")
        if torch.cuda.device_count() > 1:
            log(f"[bench] {torch.cuda.device_count()} cards: the bench steps on "
                f"cuda:{torch.cuda.current_device()} only (bench.py's sharded branch is not "
                f"ported; python3 -m gymca_torch.bench_scaling measures several ranks)")
    else:
        log("[bench] device=cpu (plain versions, host clock only)")
    smoke = a.smoke
    size = int(os.environ.get("GYMCA_BENCH_SIZE", 64 if smoke else 256))
    num_envs = int(os.environ.get("GYMCA_BENCH_ENVS", 64 if smoke else 4096))
    steps = int(os.environ.get("GYMCA_BENCH_STEPS", 10 if smoke else 1000))

    value = measure_windy(size, num_envs, steps, dev)["value"]
    base_env = os.environ.get("GYMCA_BENCH_BASELINE_SPS")
    if base_env:
        baseline = float(base_env)
    else:
        baseline = measure_reference_style_numpy(size, seconds=1.0 if smoke else 3.0)
    log(f"[bench] step_batched: {value:,.0f} steps/s | reference-style numpy single-env: "
        f"{baseline:,.0f} steps/s")

    lines = []
    if os.environ.get("GYMCA_BENCH_ADV", "1") != "0":
        adv_envs = int(os.environ.get("GYMCA_BENCH_ADV_ENVS", 8 if smoke else 64))
        adv_steps = 10 if smoke else 1000
        adv_size = min(size, 64) if smoke else size
        adv_value = measure_advanced(adv_size, adv_envs, adv_steps, dev, smoke=smoke)["value"]
        adv_base = os.environ.get("GYMCA_BENCH_ADV_BASELINE_SPS")
        lines.append({
            "metric": f"advanced{adv_size}_env_steps_per_sec",
            "value": round(adv_value, 1),
            "unit": "env-steps/s",
            "vs_baseline": round(adv_value / float(adv_base), 2) if adv_base else None,
        })
    lines.append({
        "metric": f"bulldozer{size}_env_steps_per_sec",
        "value": round(value, 1),
        "unit": "env-steps/s",
        "vs_baseline": round(value / baseline, 2),
    })
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
