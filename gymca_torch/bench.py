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
takes only ``auto``: K1 has one formulation.

bench.py's sharded branch (bench.py:75-98) runs under ``torchrun``, one rank
a card (``cuda:LOCAL_RANK``, NCCL), or gloo ranks with ``--device-cpu``:

    torchrun --standalone --nproc-per-node 4 -m gymca_torch.bench
    torchrun --standalone --nproc-per-node 2 -m gymca_torch.bench --smoke --device-cpu

When ``GYMCA_BENCH_ENVS`` divides over the d ranks and ``GYMCA_BENCH_SHARD``
is not ``0`` (bench.py's condition), rank r steps rows ``[r n/d, (r+1) n/d)``
of the batch one card steps: those rows of ``split(key(0), n)``'s reset
states and of every step's actions (each rank draws the whole batch's
actions outside the clock and keeps its rows, as bench.py draws them
globally and splits them over ``P("data")``).  Each run's clock starts after
a barrier and a synchronize on every rank and ends on each rank's own fetch
and synchronize; the run's time is the slowest rank's
(``probes.timing.clock_on_ranks``, shared with ``bench_scaling``), the value
``n * steps / best`` as on one card, the done fraction over all n envs and
each step's reward sum over all ranks.  Otherwise rank 0 steps the whole
batch, says why, and the other ranks wait.  The Advanced measure and the
numpy baseline run on rank 0 alone (bench.py's Advanced part is
single-device), while the other ranks wait on a gloo group whose timeout is
``WAIT_S``.  Only rank 0 writes stdout; each rank writes its own stderr
lines (its card, reps, launches), prefixed with its rank.

Departure from bench.py: bench.py shards over every device its one process
sees; the port shards over the ranks torchrun starts, one process a card,
PyTorch's idiom.  A plain ``python3 -m gymca_torch.bench`` on a host of
several cards steps on one of them and says so on stderr.
"""

from __future__ import annotations

import argparse
import datetime
import functools
import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from gymca_torch import rng
from gymca_torch.bench_advanced import run as advanced_run
from gymca_torch.config import resolve_device
from gymca_torch.parallel.mesh import initialize_distributed
from gymca_torch.probes.timing import card, clock_on_ranks, sync_errors

__all__ = ["windy_actions", "windy_run", "windy_shard", "measure_windy", "measure_advanced",
           "measure_reference_style_numpy", "parse_args", "main"]

WARM, REPS = 2, 3  # untimed runs, then timed runs of which the best counts
# How long the other ranks wait for rank 0 under torchrun: its Advanced runs
# and baseline (2.5-3 minutes at the defaults on an H100), and all of the
# windy runs when the batch is not sharded.
WAIT_S = 1800


def log(*parts):
    if dist.is_initialized() and dist.get_world_size() > 1:
        parts = (f"[rank {dist.get_rank()}]",) + parts
    sys.stderr.write(" ".join(map(str, parts)) + "\n")  # one write: ranks share stderr
    sys.stderr.flush()


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


def windy_run(core, reset_states, key, steps: int, group=None) -> dict:
    """One windy run of ``steps`` steps of ``core.step_batched`` from a clone
    of ``reset_states`` with the actions of :func:`windy_actions` from
    ``key``, both made before the clock starts.  With a process ``group`` of
    d ranks, ``reset_states`` are this rank's rows r of d equal blocks of the
    batch, and the run steps those rows of the whole batch's actions, timed
    by every rank (``clock_on_ranks``).  Returns ``seconds`` (the slowest
    rank's), ``own_seconds`` (this rank's), ``draw_seconds``, the end
    ``states`` (this rank's rows) and ``reward_sums`` (each step's reward
    summed over the batch, over every rank)."""
    dev = reset_states.grid.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    per = reset_states.grid.shape[0]
    t0 = time.perf_counter()
    if group is None:
        actions = windy_actions(key, steps, per)
    else:
        lo = dist.get_rank(group) * per
        actions = windy_actions(key, steps, per * dist.get_world_size(group))
        actions = actions[:, lo:lo + per].contiguous()
    states = reset_states.clone()
    sync()
    t1 = time.perf_counter()

    def steps_from(states):
        sums = []
        with sync_errors(dev):
            for a in actions:
                states, out = core.step_batched(states, a)
                sums.append(out.reward.sum())
        float(sums[-1])
        return states, torch.stack(sums)

    (states, sums), own, slowest = clock_on_ranks(functools.partial(steps_from, states), dev,
                                                  group)
    if group is not None:
        dist.all_reduce(sums, group=group)
    return {"seconds": slowest, "own_seconds": own, "draw_seconds": t1 - t0,
            "states": states, "reward_sums": sums}


def _report_reps(label, drawn, runs, envs, steps, kernel, launches, path, sharded=False):
    log(f"[bench] {label}outside each run's clock, {drawn}: "
        + ", ".join(f"{r['draw_seconds']:.3f}" for r in runs) + " s")
    log(f"[bench] {label}{kernel} launches in the {len(runs)} runs: {launches} ({path})")
    for i, r in enumerate(runs[WARM:]):
        dt = r["seconds"]
        own = f"; this rank's own {r['own_seconds'] * 1e3:.1f} ms" if sharded else ""
        log(f"[bench] {label}rep {i}: {dt * 1e3:.1f} ms ({envs * steps / dt:,.0f} steps/s){own}")


def windy_shard(num_envs: int, group):
    """Whether ``group`` shards ``num_envs`` windy envs (bench.py:78-80):
    None when it does, else the reason it does not."""
    d = dist.get_world_size(group)
    if os.environ.get("GYMCA_BENCH_SHARD", "1") == "0":
        return "GYMCA_BENCH_SHARD=0"
    if num_envs % d:
        return f"{num_envs} envs do not divide over {d} ranks"
    return None


def measure_windy(size: int, num_envs: int, steps: int, device, group=None):
    """bench.py's ``measure_tpu_native``: ``value``, env-steps/s of the best
    of ``REPS`` runs after ``WARM``, with every run (``runs``, each
    :func:`windy_run`'s dict, the end ``states`` kept for the last run only),
    the done fraction after the last, the path taken and K1's ``launches``.

    With a process ``group`` of d > 1 ranks every rank of it calls this: the
    batch is sharded over them (the module docstring), or, where
    :func:`windy_shard` gives a reason, rank 0 steps it whole and the other
    ranks return None at once.  ``states`` and ``launches`` are then this
    rank's."""
    from gymca_torch.envs.bulldozer import BulldozerCore
    from gymca_torch.ops.windy_kernel import windy_fused_step

    rank, d = 0, 1
    if group is not None and dist.get_world_size(group) > 1:
        rank, ranks, why = dist.get_rank(group), dist.get_world_size(group), \
            windy_shard(num_envs, group)
        if rank == 0:
            log(f"[bench] sharding {num_envs} envs over {ranks} ranks ({num_envs // ranks} a "
                f"rank)" if why is None else f"[bench] not sharding ({why}): rank 0 steps all "
                f"{num_envs} envs, the other {ranks - 1} ranks wait")
        if why is None:
            d = ranks
        elif rank:
            return None
    group = group if d > 1 else None
    dev = torch.device(device)
    core = BulldozerCore(size, size, device=dev)
    key = rng.key(0, device=dev)
    per = num_envs // d
    reset_states = core.initial_state(rng.split(key, num_envs)[rank * per:(rank + 1) * per])
    path = ("windy kernel K1" if dev.type == "cuda" else "K1's plain version") \
        if core.supports_fused_step() else "eager step (several CA periods a step)"
    log(f"[bench] path=step_batched, {path}, grid_dtype={core._grid_dtype} size={size} "
        f"envs={num_envs} steps={steps}" + (f", rows {rank * per}-{(rank + 1) * per - 1} here"
                                            if group is not None else ""))
    keys = [key, rng.fold_in(key, 1)] + [rng.fold_in(key, 2 + i) for i in range(REPS)]
    before = windy_fused_step.launches
    t0 = time.perf_counter()
    runs = [windy_run(core, reset_states, keys[0], steps, group)]
    log(f"[bench] first run: {time.perf_counter() - t0:.1f}s")
    runs += [windy_run(core, reset_states, k, steps, group) for k in keys[1:]]
    for r in runs[:-1]:
        del r["states"]  # a grid as large as the batch's, each
    launches = windy_fused_step.launches - before
    _report_reps("", "its actions drawn for every step and the reset states cloned", runs,
                 num_envs, steps, "K1", launches, path, sharded=group is not None)
    done = runs[-1]["states"].done.sum()
    if group is not None:
        dist.all_reduce(done, group=group)
    done = int(done) / num_envs
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
    """bench.py's ``main``: prints its two JSON lines and returns them (on
    rank 0; an empty list on the other ranks under torchrun)."""
    a = parse_args(argv)
    stencil = os.environ.get("GYMCA_BENCH_STENCIL", "auto")
    if stencil != "auto":
        raise ValueError(
            f"GYMCA_BENCH_STENCIL={stencil!r}: K1 has one formulation, so only 'auto' is "
            f"taken; the windy CA's formulations are compared by S4, python3 -m "
            f"gymca_torch.probes.exp_ca_variants")
    if "WORLD_SIZE" not in os.environ:
        return _bench(a, resolve_device("cpu" if a.device_cpu else None))
    if a.device_cpu:
        torch.set_num_threads(1)  # the ranks share the host's cores
    initialize_distributed(device="cpu" if a.device_cpu else None)
    try:
        wait = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=WAIT_S))
        dev = (torch.device("cpu") if a.device_cpu
               else torch.device("cuda", torch.cuda.current_device()))
        lines = _bench(a, dev, dist.group.WORLD)
        dist.barrier(group=wait)  # the other ranks wait here for rank 0
        return lines
    finally:
        dist.destroy_process_group()


def _bench(a, dev, group=None) -> list:
    lead = group is None or dist.get_rank(group) == 0
    if dev.type == "cuda":
        log(f"[bench] device={card()} (nvidia-smi name, power limit)")
        if group is None and torch.cuda.device_count() > 1:
            n = torch.cuda.device_count()
            log(f"[bench] {n} cards: the bench steps on cuda:{torch.cuda.current_device()} "
                f"only; torchrun --standalone --nproc-per-node {n} -m gymca_torch.bench "
                f"shards the windy batch over them (bench.py's sharded branch)")
    else:
        log("[bench] device=cpu (plain versions, host clock only)")
    smoke = a.smoke
    size = int(os.environ.get("GYMCA_BENCH_SIZE", 64 if smoke else 256))
    num_envs = int(os.environ.get("GYMCA_BENCH_ENVS", 64 if smoke else 4096))
    steps = int(os.environ.get("GYMCA_BENCH_STEPS", 10 if smoke else 1000))

    windy = measure_windy(size, num_envs, steps, dev, group)
    if not lead:
        return []
    value = windy["value"]
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
