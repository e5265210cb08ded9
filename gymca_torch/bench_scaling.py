"""Weak-scaling harness: Bulldozer env-steps/s against the number of ranks.

Counterpart of ``scripts/bench_scaling.py`` on ``torch.distributed``.  For
d = 1, 2, 4, ... up to the world size (and the world size itself), the
first d ranks each step their own ``--envs-per-device`` envs at ``--size``²
(weak scaling: more devices run more envs) and the others wait; a rep's time
is the slowest rank's.  One JSON line per d:

    {"devices": d, "steps_per_sec": v, "efficiency": v / (d * v_1)}

then the script's summary line.  On a card the step is
``BulldozerCore.step_batched`` (kernel K1), on the CPU the eager ``step``.

    torchrun --nproc-per-node N -m gymca_torch.bench_scaling          # cards, NCCL
    torchrun --nproc-per-node 2 -m gymca_torch.bench_scaling --device-cpu --smoke

Run without torchrun it is a world of one rank.  NCCL holds one rank per
card, so one card gives d = 1 only.  CPU ranks share the host's cores:
their efficiency says nothing of hardware.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import socket
import sys

import torch
import torch.distributed as dist

from gymca_torch import rng
from gymca_torch.envs.bulldozer import BulldozerCore
from gymca_torch.parallel.mesh import initialize_distributed, make_mesh
from gymca_torch.probes.timing import clock_on_ranks

SMOKE = {"size": 16, "envs_per_device": 8, "steps": 5}
WARMUP, REPS = 2, 3  # untimed runs, then timed runs of which the best counts


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--envs-per-device", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--max-devices", type=int, default=None)
    ap.add_argument("--device-cpu", action="store_true", help="gloo ranks on the CPU")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes on the CPU: %s" % SMOKE)
    a = ap.parse_args(argv)
    if a.smoke:
        a.device_cpu = True
        for k, v in SMOKE.items():
            setattr(a, k, v)
    return a


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def measure(core: BulldozerCore, group, num_envs: int, steps: int) -> float:
    """Env-steps/s of ``group``'s ranks, each stepping ``num_envs`` envs for
    ``steps`` steps from the same fresh states every run: the best of
    ``REPS`` runs after ``WARMUP``, each run's time the slowest rank's
    (``probes.timing.clock_on_ranks``).  Each rank prints its own and the
    slowest rank's time of every timed run on stderr."""
    dev = core.device
    rank = dist.get_rank()
    start = core.initial_state(rng.split(rng.key(rank, device=dev), num_envs))
    gen = torch.Generator(device=dev)
    gen.manual_seed(rank)
    actions = torch.stack([torch.randint(0, 9, (steps, num_envs), generator=gen, device=dev),
                           torch.randint(0, 2, (steps, num_envs), generator=gen, device=dev)],
                          dim=-1).to(torch.int32)
    step = core.step_batched if dev.type == "cuda" else core.step

    def run(states):
        for a in actions:
            states, _ = step(states, a)

    # step_batched updates grids in place: each run steps a clone of the start
    reps = [clock_on_ranks(functools.partial(run, start.clone()), dev, group)[1:]
            for _ in range(WARMUP + REPS)][WARMUP:]
    d = dist.get_world_size(group)
    sys.stderr.write(  # one write: ranks share stderr
        f"[scaling] rank {rank} d={d}: reps " + ", ".join(f"{own * 1e3:.1f}" for own, _ in reps)
        + " ms on this rank, " + ", ".join(f"{slow * 1e3:.1f}" for _, slow in reps)
        + " ms on the slowest\n")
    sys.stderr.flush()
    best = min(slow for _, slow in reps)
    return d * num_envs * steps / best


def run(a) -> list:
    """The sweep of parsed arguments ``a`` over the current process group:
    the records, ``{"devices", "steps_per_sec", "efficiency"}`` per d, on
    rank 0 (empty elsewhere)."""
    dev = (torch.device("cpu") if a.device_cpu
           else torch.device("cuda", torch.cuda.current_device()))
    world = dist.get_world_size()
    n_avail = min(world, a.max_devices) if a.max_devices else world
    core = BulldozerCore(a.size, a.size, device=dev)
    lead = dist.get_rank() == 0
    if lead:
        print(f"[scaling] backend={dist.get_backend()} ranks={world} size={a.size} "
              f"envs/device={a.envs_per_device} steps={a.steps} path="
              f"{'step_batched (K1)' if dev.type == 'cuda' else 'eager step'}",
              file=sys.stderr, flush=True)
        if world == 1:
            print("[scaling] a world of one rank: only d = 1 is measured"
                  + (" (NCCL holds one rank per card)" if dev.type == "cuda" else ""),
                  file=sys.stderr, flush=True)

    sizes = [1]
    while sizes[-1] * 2 <= n_avail:
        sizes.append(sizes[-1] * 2)
    if sizes[-1] != n_avail:
        sizes.append(n_avail)

    v1, results = None, []
    for d in sizes:
        mesh = make_mesh(d)  # every rank takes part in making the group
        v = None
        if dist.get_rank() < d:
            v = measure(core, mesh.get_group("data"), a.envs_per_device, a.steps)
        dist.barrier()
        if lead:
            v1 = v if v1 is None else v1
            results.append({"devices": d, "steps_per_sec": v, "efficiency": v / (d * v1)})
    return results


def main(argv=None) -> int:
    a = parse_args(argv)
    if a.device_cpu:
        torch.set_num_threads(1)
    own_group = not dist.is_initialized()
    if own_group:
        device = "cpu" if a.device_cpu else None
        if "WORLD_SIZE" in os.environ:
            initialize_distributed(device=device)
        else:
            initialize_distributed(f"localhost:{_free_port()}", 1, 0, device=device)
    try:
        results = run(a)
        for rec in results:
            print(json.dumps(rec), flush=True)
        if results:
            print(json.dumps({
                "metric": f"bulldozer{a.size}_scaling_efficiency",
                "value": results[-1]["efficiency"],
                "unit": f"fraction-of-linear@{results[-1]['devices']}dev",
                "vs_baseline": results[-1]["steps_per_sec"],
            }), flush=True)
    finally:
        if own_group:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
