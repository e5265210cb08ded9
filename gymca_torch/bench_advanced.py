"""Advanced-env step timing, the XLA-path counterpart against the fused
kernel: ``scripts/bench_advanced.py`` on the port.

    python3 -m gymca_torch.bench_advanced [--envs 8] [--size 256] [--steps 1000]
    python3 -m gymca_torch.bench_advanced --envs 2 --size 32 --steps 5 --device-cpu

For each CA path (``use_fused_ca=False``, then True: the Alexandridis kernel
K2 on the card, its plain version on the CPU), the env
``AdvancedForestFireBulldozerEnv(size, size, key=key(0), num_envs=envs)``
is reset once; a run steps ``stateless_step`` then ``conditional_reset``
from that reset, with the script's actions ``[randint(k, (N,), 0, 9),
randint(fold_in(k, 1), (N,), 0, 2), 0]`` for the ``t``-th key ``k`` of
``split(key, steps)``: one untimed run from ``key(1)``, then the best of 3
from ``key(2 + i)`` (:func:`run`: each run's actions drawn in bulk before
its clock starts, where the script draws them inside its jitted scan at
next to no cost; on a card the steps under
``torch.cuda.set_sync_debug_mode("error")``; the clock ends on a fetch of
the last step's reward sum and a synchronize).  ``gymca_torch.bench`` runs
the Advanced half of ``bench.py`` through :func:`run` too.

Prints the script's line for each path with the device's own numbers beside
it (a traced run of the first 10 steps: device busy µs and kernels a step,
idle share).  Runs on
the card; ``--device-cpu`` runs on the CPU with the host clock only.
"""

from __future__ import annotations

import argparse
import time

import torch

from gymca_torch import rng
from gymca_torch.config import resolve_device
from gymca_torch.probes import kernel_inputs as ki
from gymca_torch.probes.timing import (
    TRACE_STEPS,
    card,
    device_note,
    profile_steps,
    sync_errors,
)

__all__ = ["parse_args", "step_actions", "run", "measure", "report", "main"]

# The labels are the script's: "fused Pallas CA" names the fused path (the
# CUDA kernel here), "XLA CA" the XLA-path counterpart.


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Advanced-env step timing, both CA paths")
    ap.add_argument("--envs", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--device-cpu", action="store_true",
                    help="run on the CPU (host clock only)")
    return ap.parse_args(argv)


def step_actions(keys, n: int):
    """The script's actions for step keys ``keys`` (..., 2): ``(..., n, 3)``
    int32 ``[randint(k, (n,), 0, 9), randint(fold_in(k, 1), (n,), 0, 2),
    0]``."""
    move = rng.randint(keys, (n,), 0, 9)
    return torch.stack([move, rng.randint(rng.fold_in(keys, 1), (n,), 0, 2),
                        torch.zeros_like(move)], dim=-1)


def run(env, obs, info, seed: int, steps: int) -> dict:
    """One run of ``steps`` steps of ``stateless_step`` + ``conditional_reset``
    from ``(obs, info)``, the actions those of ``split(key(seed), steps)``
    (:func:`step_actions`), drawn before the clock starts.  On a card the
    steps run under ``set_sync_debug_mode("error")``; the clock ends on a
    fetch of the last step's reward sum and a synchronize.  Returns
    ``seconds``, ``draw_seconds`` and the run's end: ``obs``, ``info``,
    ``reward_sums`` (each step's reward summed over the envs) and
    ``terminated``, the last step's flags before its conditional reset."""
    dev = env.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    acts = step_actions(rng.split(rng.key(seed, device=dev), steps), env.num_envs)
    sync()
    t1 = time.perf_counter()
    sums = []
    with sync_errors(dev):
        obs, info, last = ki.adv_run(env, obs, info, acts, sums)
    float(sums[-1])
    sync()
    t2 = time.perf_counter()
    return {"seconds": t2 - t1, "draw_seconds": t1 - t0, "obs": obs, "info": info,
            "reward_sums": torch.stack(sums), "terminated": last[2]}


def measure(use_fused_ca: bool, envs: int, size: int, steps: int, device,
            smi=None) -> dict:
    """ms a step (the best of 3 runs after one untimed, :func:`run`) of
    ``stateless_step`` + ``conditional_reset`` on one CA path, and on a card
    the device's numbers of one more run traced."""
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv

    dev = torch.device(device)
    env = AdvancedForestFireBulldozerEnv(size, size, key=rng.key(0, device=dev),
                                         num_envs=envs, use_fused_ca=use_fused_ca, device=dev)
    obs, info = env.reset()
    run(env, obs, info, 1, steps)
    best = min(run(env, obs, info, 2 + i, steps)["seconds"] for i in range(3))
    out = {"use_fused_ca": env.use_fused_ca, "ms_per_step": best / steps * 1e3,
           "env_steps_per_s": envs * steps / best, "busy_us_per_step": None,
           "kernels_per_step": None, "idle_share": None}
    if dev.type == "cuda":
        acts = step_actions(rng.split(rng.key(2, device=dev), steps), envs)[:TRACE_STEPS]
        prof = profile_steps(lambda: ki.adv_run(env, obs, info, acts), len(acts),
                             f"Advanced step {envs} x {size}², use_fused_ca={env.use_fused_ca}",
                             smi or card(), top=5)
        if prof is not None:
            out.update({k: prof[k] for k in ("busy_us_per_step", "kernels_per_step",
                                             "idle_share")})
    return out


def report(size: int, envs: int, r: dict):
    """The script's line for one path's :func:`measure`, with the device's
    numbers beside it."""
    name = "fused Pallas CA" if r["use_fused_ca"] else "XLA CA"
    print(f"advanced {size}^2 x {envs} envs, {name}: {r['ms_per_step']:7.3f} ms/step "
          f"({r['env_steps_per_s']:,.0f} env-steps/s)  | {device_note(r)}", flush=True)


def main(argv=None) -> list:
    """Both paths, the script's line for each: returns their numbers."""
    a = parse_args(argv)
    dev = resolve_device("cpu" if a.device_cpu else None)
    smi = card() if dev.type == "cuda" else None
    if smi:
        print(f"[bench_advanced] {smi}", flush=True)
    results = []
    for use_fused in (False, True):
        results.append(measure(use_fused, a.envs, a.size, a.steps, dev, smi))
        report(a.size, a.envs, results[-1])
    return results


if __name__ == "__main__":
    main()
