"""Checks of ``gymca_torch.parallel`` across several ranks of one host:
halo exchange on real bands, the batched mesh, the Advanced step against
the CPU, data-parallel PPO's replicas, ``bench_scaling`` up to the world
size, and ``gymca_torch.bench``'s windy measure sharded over the ranks.
Not a pytest file: run it under torchrun, one rank a card,

    torchrun --standalone --nproc-per-node 4 tests/torch_multicard.py          # NCCL
    torchrun --standalone --nproc-per-node 4 tests/torch_multicard.py --device-cpu
    torchrun --standalone --nproc-per-node 4 tests/torch_multicard.py --checks bench

(``--device-cpu``: gloo ranks at toy sizes; ``tests/test_torch_multihost.py``
runs it so; ``--checks`` runs only the checks named).  Rank 0 prints the
card's ``nvidia-smi`` name and power limit and one ``MULTICARD {...}`` JSON
line; the exit code is non-zero unless every check held.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gymca_torch import bench, bench_scaling, config, rng  # noqa: E402
from gymca_torch.agents.args import Args, EnvArgs, ExperimentArgs, PPOArgs  # noqa: E402
import gymca_torch.envs.bulldozer as bulldozer  # noqa: E402
from gymca_torch.core.env import tree_map  # noqa: E402
from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv  # noqa: E402
from gymca_torch.envs.bulldozer import BulldozerCore  # noqa: E402
from gymca_torch.ops.windy import windy_step  # noqa: E402
from gymca_torch.ops.alexandridis_kernel import alexandridis_fused_step  # noqa: E402
from gymca_torch.ops.windy_kernel import windy_fused_step  # noqa: E402
from gymca_torch.parallel.mesh import (  # noqa: E402
    collective_device,
    initialize_distributed,
    make_2d_mesh,
    make_mesh,
)
from gymca_torch.parallel.sharded import DataParallelPPO  # noqa: E402
from gymca_torch.parallel.spatial import gather_rows, shard_rows, windy_step_spatial  # noqa: E402
from gymca_torch.parallel.spatial_env import (  # noqa: E402
    advanced_step_spatial,
    bulldozer_step_batched_spatial,
    bulldozer_step_spatial,
    shard_state,
    shard_state_batched,
)

# (card size, CPU size) of each check
WINDY = ((8192, 1024), (64, 32))
BULLDOZER, ADVANCED, PPO_SIZE = (4096, 64), (1024, 64), (64, 16)
BATCH = ((64, 256), (8, 64))  # (envs, size) on the (2, 2) mesh
BENCH = ((4096, 256, 200), (16, 48, 5))  # (envs, size, steps) of the sharded bench
CHECKS = ("windy", "bulldozer", "batched", "advanced", "ppo", "scaling", "bench")


def windy_on_bands(mesh, dev, g, shape):
    """10 windy steps of one grid on the mesh's bands against the whole grid."""
    cells = torch.tensor([0, 3, 25], dtype=torch.int8, device=dev)
    grid = cells[torch.randint(0, 3, shape, generator=g, device=dev)]
    wind = torch.full((3, 3), 0.6, device=dev)
    wind[1, 1] = 0
    band, whole = shard_rows(grid, mesh), grid.clone()
    for i in range(10):
        k = rng.fold_in(rng.key(42, device=dev), i)
        band = windy_step_spatial(band, wind, k, mesh, empty=0, tree=3, fire=25)
        whole = windy_step(whole[None], wind, k[None], empty=0, tree=3, fire=25)[0]
    return torch.equal(gather_rows(band, mesh.get_group("data")), whole)


def bulldozer_on_bands(mesh, dev, g, size):
    """10 Bulldozer steps of one grid on the mesh's bands against
    ``BulldozerCore.step`` of the whole grid, every leaf."""
    core = BulldozerCore(size, size, device=dev)
    ref = core.initial_state(rng.split(rng.key(3, device=dev), 1))
    state = shard_state(ref.clone(), mesh)
    group, ok = mesh.get_group("data"), True
    for _ in range(10):
        r = torch.randint(0, 18, (1,), generator=g, device=dev)
        a = torch.stack([r // 2, r % 2], -1).to(torch.int32)
        state, out = bulldozer_step_spatial(core, state, a, mesh)
        ref, r_out = core.step(ref, a)
        ok &= torch.equal(gather_rows(state.grid, group, 1), ref.grid)
        ok &= all(torch.equal(state.context[k], ref.context[k]) for k in ref.context)
        ok &= torch.equal(state.key, ref.key) and torch.equal(out.reward, r_out.reward)
        ok &= torch.equal(out.info["hit"], r_out.info["hit"])
    return bool(ok)


def bulldozer_on_2x2(dev, g, n, size):
    """10 steps of ``n`` envs on a (2, 2) mesh against ``core.step``."""
    mesh = make_2d_mesh(2, 2)
    core = BulldozerCore(size, size, device=dev)
    ref = core.initial_state(rng.split(rng.key(4, device=dev), n))
    states = shard_state_batched(ref.clone(), mesh)
    lo = n // 2 * mesh.get_local_rank("data")
    ok = True
    for _ in range(10):
        r = torch.randint(0, 18, (n,), generator=g, device=dev)
        a = torch.stack([r // 2, r % 2], -1).to(torch.int32)
        states, out = bulldozer_step_batched_spatial(core, states, a[lo:lo + n // 2], mesh)
        ref, r_out = core.step(ref, a)
        rows = gather_rows(states.grid, mesh.get_group("space"), 1)
        ok &= torch.equal(gather_rows(rows, mesh.get_group("data")), ref.grid)
        ok &= torch.equal(gather_rows(out.reward, mesh.get_group("data")), r_out.reward)
    return bool(ok)


def advanced_against_cpu(mesh, dev, size):
    """5 Advanced steps of one grid on the mesh's bands, the mesh's device
    against a gloo mesh of CPU tensors, every leaf."""
    cpu_mesh = DeviceMesh.from_group(dist.new_group(backend="gloo"), "cpu",
                                     mesh_dim_names=("data",))
    env = AdvancedForestFireBulldozerEnv(size, size, key=rng.key(0, device=dev), num_envs=1,
                                         device=dev)
    (_, ctx), _ = env.reset()
    pe = {k: v[0] for k, v in ctx["per_env_context"].items()}
    pe["position"] = ctx["position"][0]
    pe = {k: shard_rows(v, mesh, dim=-2 if k == "exp_slope" else 0)
          if v.dim() >= 2 and (k == "exp_slope" or v.shape[0] == size) else v
          for k, v in pe.items()}
    cpu_pe = {k: v.cpu() for k, v in pe.items()}
    shared = ctx["shared_context"]
    cpu_shared = {k: v.cpu() if torch.is_tensor(v) else v for k, v in shared.items()}
    ok = True
    for a in ([4, 1], [1, 1], [7, 0], [3, 1], [4, 0]):
        a = torch.tensor(a, dtype=torch.int32, device=dev)
        g1, pe, r1, d1 = advanced_step_spatial(env.ca, pe["true_grid"], pe, shared, a,
                                               pe["key"], mesh)
        g2, cpu_pe, r2, d2 = advanced_step_spatial(env.ca, cpu_pe["true_grid"], cpu_pe,
                                                   cpu_shared, a.cpu(), cpu_pe["key"], cpu_mesh)
        ok &= torch.equal(g1.cpu(), g2) and torch.equal(r1.cpu(), r2)
        ok &= torch.equal(d1.cpu(), d2)
        ok &= all(torch.equal(pe[k].cpu(), cpu_pe[k]) for k in pe)
    return bool(ok)


def ppo_replicas(mesh, dev, size, world):
    """Two ``DataParallelPPO`` iterations of 2 envs a rank: finite metrics
    and the same params on every rank."""
    n = 2 * world
    env = AdvancedForestFireBulldozerEnv(size, size, key=rng.key(0, device=dev), num_envs=n,
                                         device=dev)
    args = Args(ppo=PPOArgs(num_minibatches=2, update_epochs=2),
                env=EnvArgs(num_envs=n, size=size),
                exp=ExperimentArgs(num_ppo_steps=8, total_timesteps=n * 8 * 4))
    dp = DataParallelPPO(env, args, mesh, key=rng.key(5, device=dev), device=dev)
    carry = dp.init_carry()
    for _ in range(2):
        *carry, metrics = dp.train_iteration(*carry)
    flat = torch.cat([v.reshape(-1) for d in carry[0].params.values() for v in d.values()])
    every = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(every, flat)
    finite = all(bool(torch.isfinite(v)) for v in metrics.values())
    return {"params_equal_on_every_rank": all(torch.equal(every[0], e) for e in every),
            "metrics_finite": finite, "grad_all_reduces": dp.trainer.grad_all_reduces}


def bench_sharded(dev, n, size, steps, world):
    """``gymca_torch.bench``'s windy measure sharded over the world's ranks,
    then, on rank 0, the same ``n`` envs alone (no group): the last run's
    end states gathered from the ranks equal the run alone's in every leaf
    and after ``materialize_grid``, bit for bit, and so does the done
    fraction over all ``n`` envs; each rank's K1 calls are
    ``(WARM + REPS) * steps`` of ``n / world`` envs, and on a card K1's
    launch counter reads as many and K2's none."""
    calls, real = [], bulldozer.windy_fused_step

    def counted(*args, **kw):
        calls.append(int(args[0].shape[0]))
        return real(*args, **kw)

    windy_fused_step.launches = alexandridis_fused_step.launches = 0
    bulldozer.windy_fused_step = counted
    try:
        m = bench.measure_windy(size, n, steps, dev, dist.group.WORLD)
    finally:
        bulldozer.windy_fused_step = real
    runs = (bench.WARM + bench.REPS) * steps
    launches = {"windy": windy_fused_step.launches,
                "alexandridis": alexandridis_fused_step.launches}
    exact = calls == [n // world] * runs and (
        dev.type != "cuda" or launches == {"windy": runs, "alexandridis": 0})
    exact = torch.tensor([int(exact)], device=collective_device())
    dist.all_reduce(exact, op=dist.ReduceOp.MIN)
    equal = torch.zeros(1, dtype=torch.int64, device=collective_device())
    last = m["runs"][-1]
    states = tree_map(lambda x: gather_rows(x, None), last["states"])
    own = torch.tensor([r["own_seconds"] for r in m["runs"]], dtype=torch.float64,
                       device=collective_device())
    every = [torch.empty_like(own) for _ in range(world)]
    dist.all_gather(every, own)
    out = {}
    if dist.get_rank() == 0:
        core = bulldozer.BulldozerCore(size, size, device=dev)
        alone = bench.measure_windy(size, n, steps, dev)
        a = alone["runs"][-1]["states"]
        leaves = []
        tree_map(lambda x, y: leaves.append(torch.equal(x, y)), states, a)
        equal[0] = (all(leaves) and m["done_fraction"] == alone["done_fraction"]
                    and torch.equal(core.materialize_grid(states), core.materialize_grid(a)))
        out = {"envs": n, "size": size, "steps": steps, "value": m["value"],
               "value_alone": alone["value"], "done_fraction": m["done_fraction"],
               "done_fraction_alone": alone["done_fraction"],
               "launches_rank0": launches,
               "reps_ms_slowest": [r["seconds"] * 1e3 for r in m["runs"][bench.WARM:]],
               "reps_ms_by_rank": [[float(t) * 1e3 for t in e[bench.WARM:]] for e in every],
               "reps_ms_alone": [r["seconds"] * 1e3 for r in alone["runs"][bench.WARM:]]}
    dist.broadcast(equal, 0)
    return {"bench_states_equal": bool(equal), "bench_launches_exact_on_every_rank":
            bool(exact), "bench": out or None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device-cpu", action="store_true", help="gloo ranks at toy sizes")
    ap.add_argument("--checks", nargs="+", choices=CHECKS, default=list(CHECKS),
                    help="the checks to run (default: all)")
    a = ap.parse_args(argv)
    cpu = a.device_cpu
    if cpu:
        config.DEFAULT_DEVICE = "cpu"
        torch.set_num_threads(1)
    initialize_distributed(device="cpu" if cpu else None)
    try:
        world, lead = dist.get_world_size(), dist.get_rank() == 0
        dev = torch.device("cpu") if cpu else torch.device("cuda", torch.cuda.current_device())
        pick = 1 if cpu else 0
        mesh = make_mesh()
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        steps = ["--smoke"] if cpu else ["--steps", "200"]
        checks = {
            "windy": lambda: {"windy_equal": windy_on_bands(mesh, dev, g, WINDY[pick])},
            "bulldozer": lambda: {"bulldozer_spatial_equal": bulldozer_on_bands(
                mesh, dev, g, BULLDOZER[pick])},
            "batched": lambda: {"bulldozer_batched_2x2_equal": (
                bulldozer_on_2x2(dev, g, *BATCH[pick]) if world == 4 else None)},
            "advanced": lambda: {"advanced_equals_cpu": advanced_against_cpu(
                mesh, dev, ADVANCED[pick])},
            "ppo": lambda: ppo_replicas(mesh, dev, PPO_SIZE[pick], world),
            "scaling": lambda: {"scaling": bench_scaling.run(bench_scaling.parse_args(steps))},
            "bench": lambda: bench_sharded(dev, *BENCH[pick], world),
        }
        t0 = time.perf_counter()
        out = {"world": world, "backend": dist.get_backend(), "checks": a.checks}
        for name in a.checks:
            out.update(checks[name]())
        out["seconds"] = time.perf_counter() - t0
        held = [v for k, v in out.items() if k.endswith(("_equal", "_cpu", "_rank", "_finite"))
                and v is not None]
        ok = all(held)
        if lead:
            if not cpu:
                print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                      "--format=csv,noheader"], capture_output=True,
                                     text=True).stdout.strip(), flush=True)
            print("MULTICARD " + json.dumps({"ok": ok, **out}), flush=True)
        return 0 if ok else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
