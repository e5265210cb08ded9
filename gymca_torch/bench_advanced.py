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
from ``key(2 + i)``, each to a synchronize.  Each run's actions are drawn in
bulk before its clock starts (the script draws them inside its jitted scan,
where they cost next to nothing).

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
from gymca_torch.probes.timing import TRACE_STEPS, card, device_note, profile_steps

__all__ = ["parse_args", "step_actions", "measure", "report", "main"]

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


def measure(use_fused_ca: bool, envs: int, size: int, steps: int, device,
            smi=None) -> dict:
    """ms a step (the best of 3 runs after one untimed) of ``stateless_step``
    + ``conditional_reset`` on one CA path, and on a card the device's
    numbers of one more run traced."""
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    env = AdvancedForestFireBulldozerEnv(size, size, key=rng.key(0, device=dev),
                                         num_envs=envs, use_fused_ca=use_fused_ca, device=dev)
    obs, info = env.reset()

    def actions(seed):
        return step_actions(rng.split(rng.key(seed, device=dev), steps), envs)

    def steps_of(acts):
        o, i = obs, info
        for a in acts:
            st = env.stateless_step(a, o, i)
            o, _, _, _, i = env.conditional_reset(st, a)

    def timed(seed):
        acts = actions(seed)
        sync()
        t0 = time.perf_counter()
        steps_of(acts)
        sync()
        return time.perf_counter() - t0

    timed(1)
    best = min(timed(2 + i) for i in range(3))
    out = {"use_fused_ca": env.use_fused_ca, "ms_per_step": best / steps * 1e3,
           "env_steps_per_s": envs * steps / best, "busy_us_per_step": None,
           "kernels_per_step": None, "idle_share": None}
    if cuda:
        acts = actions(2)[:TRACE_STEPS]
        prof = profile_steps(lambda: steps_of(acts), len(acts), f"Advanced step {envs} x "
                             f"{size}², use_fused_ca={env.use_fused_ca}", smi or card(), top=5)
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
