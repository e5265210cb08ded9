"""Phase attribution of the Advanced env step: ``scripts/exp_advanced_split.py``
on the port.

    python3 -m gymca_torch.exp_advanced_split [--size 256] [--envs 64] [--steps 1000]
    python3 -m gymca_torch.exp_advanced_split --size 32 --envs 4 --steps 5 --device-cpu

Each variant runs on a fresh env (``AdvancedForestFireBulldozerEnv(size,
size, key=key(0), num_envs=envs)``, the fused kernel K2 on the card), from
its reset, with the script's actions (``[randint(k, (N,), 0, 9),
randint(fold_in(k, 1), (N,), 0, 2), 0]`` for the ``t``-th key ``k`` of
``split(key, steps)``), one run from ``key(1)``, one from ``fold_in(key(1),
1)`` and the best of 3 from ``fold_in(key(1), i + 2)``:

  full         ``stateless_step`` + ``conditional_reset``
  step_only    ``stateless_step`` alone
  step_no_obs  ``stateless_step`` of an env whose observation build is a
               zero stub (the env's ``_observe``, which both its step and
               its reset call, replaced on the instance)
  step_no_ca   ``stateless_step`` with the fused CA an identity stub (the
               ``alexandridis_fused_step`` that ``gymca_torch.envs.advanced``
               calls, replaced for the variant: it launches no K2)
  obs_iso      the batched ``_grid_to_rgb`` alone on the reset grid, the
               grid carried through ``grid ^ (rgb[..., 0] > 200)``
  ca_iso       K2 alone carrying grid and ages, seeds the key data of
               ``fold_in(k, arange(N))`` (only where the env runs the
               fused kernel)

Each run's actions and seeds are drawn in bulk before its clock starts (the
script draws them inside its jitted scan).  Prints one JSON line with the
script's keys (``size``, ``envs``, ``*_us``, ``reset_overhead_us``,
``obs_in_situ_us``, ``ca_in_situ_us``, ``steps_per_sec_full``) and, beside
each time, the device's own numbers (``*_device_busy_us``,
``*_kernels_per_step``, ``*_idle_share``: a traced run of 10 steps) and the K2
launches each variant made (``k2_launches``, counted on the card);
``ca_iso`` adds K2's device µs per launch (``ca_iso_k2_device_us``) beside
its bound (``ca_iso_k2_bound_us``).  Runs on the card; ``--device-cpu`` runs
on the CPU (the XLA-path counterpart, as the script's CPU run) with the host
clock only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from gymca_torch import rng
from gymca_torch.config import resolve_device
from gymca_torch.ops import alexandridis_kernel
from gymca_torch.ops.alexandridis_kernel import alexandridis_fused_step
from gymca_torch.ops.stencil import NEIGHBOR_OFFSETS
from gymca_torch.probes import kernel_inputs as ki
from gymca_torch.probes.timing import TRACE_STEPS, card, profile_steps, time_launches

__all__ = ["parse_args", "make_env", "actions", "fold_in_range", "identity_ca",
           "ca_stubbed", "obs_iso_step", "scan_time", "main"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Phase attribution of the Advanced env step")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--device-cpu", action="store_true",
                    help="run on the CPU (host clock only)")
    return ap.parse_args(argv)


def make_env(size, envs, *, obs_stub=False, device=None, use_fused_ca=None):
    """A fresh env; with ``obs_stub`` its observation build returns zeros
    (``_observe``, the one function its step and reset render through)."""
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv

    env = AdvancedForestFireBulldozerEnv(size, size, key=rng.key(0, device=device),
                                         num_envs=envs, use_fused_ca=use_fused_ca,
                                         device=device)
    if obs_stub:
        def zero_observe(grid, position, full_action, per_env):
            return torch.zeros(grid.shape + (3,), dtype=env._obs_dtype, device=grid.device)

        env._observe = zero_observe
    return env


def actions(keys, n: int):
    """The script's ``acts(k)`` for step keys ``keys`` (..., 2): ``(..., n,
    3)`` int32."""
    move = rng.randint(keys, (n,), 0, 9)
    return torch.stack([move, rng.randint(rng.fold_in(keys, 1), (n,), 0, 2),
                        torch.zeros_like(move)], dim=-1)


def fold_in_range(keys, n: int):
    """Key data of ``vmap(fold_in, (None, 0))(k, arange(n))`` for each key of
    ``keys`` (..., 2): ``(..., n, 2)``."""
    k1 = keys[..., 0, None].expand(*keys.shape[:-1], n)
    k2 = keys[..., 1, None].expand(*keys.shape[:-1], n)
    data = torch.arange(n, dtype=keys.dtype, device=keys.device).expand_as(k1)
    b1, b2 = rng.threefry2x32(k1, k2, torch.zeros_like(k1), data)
    return torch.stack([b1, b2], dim=-1)


def identity_ca(grid, fire_age, dousing, vdf, exp_slope, wind_rows, seeds, **kw):
    """The script's CA stub: the grid and the ages unchanged."""
    return grid.to(torch.int8), fire_age.to(torch.float32)


@contextlib.contextmanager
def ca_stubbed():
    """While open, the Advanced env's fused CA is :func:`identity_ca`."""
    import gymca_torch.envs.advanced as advanced

    real = advanced.alexandridis_fused_step
    advanced.alexandridis_fused_step = identity_ca
    try:
        yield
    finally:
        advanced.alexandridis_fused_step = real


def obs_iso_step(env, grid, position, dousing, is_night):
    """One step of the script's ``obs_iso``: the RGB of ``grid`` and the grid
    carried as ``grid ^ (rgb[..., 0] > 200)``."""
    rgb = env._grid_to_rgb(grid.to(torch.float32), is_night, dousing, position)
    return grid ^ (rgb[..., 0] > 200).to(grid.dtype)


def scan_time(step_fn, carry, steps, inputs, name, device, smi=None, reps=3):
    """The script's ``scan_time``: ``step_fn(carry, x)`` over the per-step
    inputs ``inputs(key)`` (drawn in bulk, outside the clock) of the keys of
    ``split(key, steps)``: one run from ``key(1)``, one from ``fold_in(key(1),
    1)``, the best of ``reps`` from ``fold_in(key(1), i + 2)``, each from
    ``carry`` and to a synchronize.  Returns seconds a step and, on a card,
    the device's numbers of a run of ``TRACE_STEPS`` steps traced."""
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    key = rng.key(1, device=device)

    def loop(xs):
        c = carry
        for x in xs:
            c = step_fn(c, x)
        return c

    def run(k):
        xs = inputs(rng.split(k, steps))
        sync()
        t0 = time.perf_counter()
        loop(xs)
        sync()
        return time.perf_counter() - t0

    print(f"[split] {name}: first run {run(key):.1f}s", file=sys.stderr, flush=True)
    run(rng.fold_in(key, 1))
    best = min(run(rng.fold_in(key, i + 2)) for i in range(reps))
    print(f"[split] {name}: {best / steps * 1e6:.1f} us/step", file=sys.stderr, flush=True)
    dev_numbers = None
    if cuda:
        xs = inputs(rng.split(rng.fold_in(key, 2), steps))[:TRACE_STEPS]
        dev_numbers = profile_steps(lambda: loop(xs), len(xs), name, smi or card(), top=5)
    return best / steps, dev_numbers


def main(argv=None) -> dict:
    """Every variant: prints the JSON line and returns it."""
    a = parse_args(argv)
    dev = resolve_device("cpu" if a.device_cpu else None)
    smi = card() if dev.type == "cuda" else None
    n = a.envs
    results, device, k2 = {}, {}, {}

    def act_inputs(keys):
        return actions(keys, n)

    def timed(name, step_fn, carry, inputs=act_inputs):
        before = alexandridis_kernel.alexandridis_fused_step.launches
        results[name], device[name] = scan_time(step_fn, carry, a.steps, inputs, name, dev, smi)
        k2[name] = alexandridis_kernel.alexandridis_fused_step.launches - before

    # --- full + step_only on the same env ------------------------------------
    env = make_env(a.size, n, device=dev)
    print(f"[split] size={a.size} envs={n} "
          f"path={'fused-kernel' if env.use_fused_ca else 'xla'} "
          f"device={smi or dev.type}", file=sys.stderr)
    obs, info = env.reset()

    def full(carry, aa):
        st = env.stateless_step(aa, *carry)
        o2, _, _, _, i2 = env.conditional_reset(st, aa)
        return o2, i2

    def step_only(carry, aa):
        o2, _, _, _, i2 = env.stateless_step(aa, *carry)
        return o2, i2

    timed("full", full, (obs, info))
    timed("step_only", step_only, (obs, info))

    # --- the observation build stubbed out (a fresh env) ----------------------
    env2 = make_env(a.size, n, obs_stub=True, device=dev)
    obs2, info2 = env2.reset()

    def step_noobs(carry, aa):
        o2, _, _, _, i2 = env2.stateless_step(aa, *carry)
        return o2, i2

    timed("step_no_obs", step_noobs, (obs2, info2))

    # --- the CA stubbed out (a fresh env, stepped while the stub is in place)
    with ca_stubbed():
        env3 = make_env(a.size, n, device=dev)
        obs3, info3 = env3.reset()

        def step_noca(carry, aa):
            o2, _, _, _, i2 = env3.stateless_step(aa, *carry)
            return o2, i2

        timed("step_no_ca", step_noca, (obs3, info3))

    # --- the observation build isolated ---------------------------------------
    per_env = obs[1]["per_env_context"]
    pos = obs[1]["position"]
    dousing, is_night = per_env["dousing_count"], per_env["is_night"]
    timed("obs_iso", lambda grid, aa: obs_iso_step(env, grid, pos, dousing, is_night),
          per_env["true_grid"])

    # --- the fused kernel isolated --------------------------------------------
    if env.use_fused_ca:
        shared = obs[1]["shared_context"]
        wm = shared["winds"][per_env["wind_index"].long()]
        wind_rows = torch.stack([wm[:, 1 + dr, 1 + dc] for dr, dc in NEIGHBOR_OFFSETS],
                                dim=-1)
        kw = ki.alexandridis_keywords(env.ca)

        def ca_iso(carry, seeds):
            grid, age = carry
            return alexandridis_fused_step(
                grid, age, dousing, per_env["veg_den_factor"], per_env["exp_slope"],
                wind_rows, seeds, **kw)

        start = (per_env["true_grid"], per_env["fire_age"])
        timed("ca_iso", ca_iso, start, inputs=lambda keys: fold_in_range(keys, n))
        if dev.type == "cuda":
            seeds = fold_in_range(rng.split(rng.key(1, device=dev), a.steps), n)

            def chain():
                c = start
                for s in seeds:
                    c = ca_iso(c, s)

            t = time_launches(chain, a.steps, "alexandridis_kernel")
            keep = {0, a.steps // 2, a.steps - 1}
            with ki.alexandridis_recorder(keep, sys.modules[__name__]) as rec:
                chain()
            b = ki.k2_bound(rec)
            device["ca_iso"] = dict(device["ca_iso"] or {}, k2_device_us=t["device_us"],
                                    k2_bound_us=b["bound_ms"] * 1e3, k2_bound_by=b["by"])

    us = lambda t: round(t * 1e6, 1)  # noqa: E731 (the script's rounding)
    out = {"size": a.size, "envs": n}
    out.update({f"{k}_us": us(v) for k, v in results.items()})
    out["reset_overhead_us"] = us(results["full"] - results["step_only"])
    out["obs_in_situ_us"] = us(results["step_only"] - results["step_no_obs"])
    out["ca_in_situ_us"] = us(results["step_only"] - results["step_no_ca"])
    out["steps_per_sec_full"] = round(n / results["full"], 1)
    for name, d in device.items():
        d = d or {}
        out[f"{name}_device_busy_us"] = d.get("busy_us_per_step")
        out[f"{name}_kernels_per_step"] = d.get("kernels_per_step")
        out[f"{name}_idle_share"] = d.get("idle_share")
        for k in ("k2_device_us", "k2_bound_us", "k2_bound_by"):
            if k in d:
                out[f"{name}_{k}"] = d[k]
    out["k2_launches"] = k2
    out["device"] = smi or dev.type
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
