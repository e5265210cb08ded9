"""Rank bodies of the port's parallel tests, run as spawned gloo processes.

Not a test file (pytest collects only ``test_*.py``).  The tests call
:func:`run_world`: it writes the cases and their inputs to a directory,
spawns ``world`` processes with ``torch.multiprocessing`` (one intra-op
thread each, a ``file://`` store in that directory, so parallel test
workers never share a store or a port), and returns what each rank wrote
back.  The ranks import torch, numpy and the port only, never JAX: the
tests compare their results with the JAX package in the pytest process.

A case is ``(name, function name, inputs)``; each rank runs the function
of this module named so with the inputs and stores its return value, or
``{"raised": exception name}``, under ``name``.
"""

from __future__ import annotations

import datetime
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = str(Path(__file__).resolve().parent.parent)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TIMEOUT_S = 240


def run_world(world: int, cases, directory, env=None, timeout=TIMEOUT_S):
    """Run ``cases`` on ``world`` spawned gloo ranks; a list, by rank, of
    ``{case name: result}``.  ``env`` is set in each rank's environment."""
    import torch.multiprocessing as mp

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    torch.save({"cases": cases, "env": env or {}}, directory / "cases.pt")
    ctx = mp.start_processes(_rank, args=(world, str(directory)), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks did not finish in {timeout} s")
    return [torch.load(directory / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _rank(rank: int, world: int, directory: str):
    import torch.distributed as dist

    torch.set_num_threads(1)
    spec = torch.load(Path(directory) / "cases.pt", weights_only=False)
    os.environ.update(spec["env"])
    dist.init_process_group("gloo", init_method=f"file://{directory}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        for name, fn, inputs in spec["cases"]:
            try:
                out[name] = globals()[fn](inputs)
            except (AssertionError, ValueError) as e:
                out[name] = {"raised": type(e).__name__, "message": str(e)}
            dist.barrier()
    finally:
        torch.save(out, Path(directory) / f"rank{rank}.pt")
        dist.destroy_process_group()


# --- helpers --------------------------------------------------------------------------


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _gather_2d(block, mesh, row_dim=1):
    """The whole batch from a ``(data, space)`` block: rows over ``space``,
    then envs over ``data``."""
    from gymca_torch.parallel.spatial import gather_rows

    rows = gather_rows(block, mesh.get_group("space"), dim=row_dim)
    return gather_rows(rows, mesh.get_group("data"), dim=0)


# --- spatial steps ----------------------------------------------------------------------


def windy(inp):
    """``windy_step_spatial`` from one grid over ``inp["keys"]``; the whole
    grid after each step."""
    from gymca_torch.parallel.mesh import make_mesh
    from gymca_torch.parallel.spatial import gather_rows, shard_rows, windy_step_spatial

    mesh = make_mesh(inp["devices"])
    band = shard_rows(_t(inp["grid"]), mesh)
    wind = _t(inp["wind"])
    grids = []
    for k in inp["keys"]:
        band = windy_step_spatial(band, wind, _t(k), mesh, empty=inp["empty"],
                                  tree=inp["tree"], fire=inp["fire"])
        grids.append(_np(gather_rows(band, mesh.get_group("data"))))
    return grids


def rows_not_divisible(inp):
    from gymca_torch.parallel.mesh import make_mesh
    from gymca_torch.parallel.spatial import shard_rows

    shard_rows(torch.zeros(inp["shape"], dtype=torch.int32), make_mesh(inp["devices"]))
    return "no error"


def _bulldozer_record(states, out, grid):
    return {"grid": _np(grid), "reward": _np(out.reward), "done": _np(out.terminated),
            "hit": _np(out.info["hit"]), "key": _np(states.key),
            "position": _np(states.context["position"]), "time": _np(states.context["time"]),
            "tree_count": _np(states.context["tree_count"]),
            "fire_count": _np(states.context["fire_count"]),
            "steps_elapsed": _np(states.steps_elapsed),
            "reward_accumulated": _np(states.reward_accumulated)}


def bulldozer(inp):
    """``bulldozer_step_spatial`` of the envs of ``inp["keys"]`` on
    ``devices`` bands, one record a step."""
    from gymca_torch.envs.bulldozer import BulldozerCore
    from gymca_torch.parallel.mesh import make_mesh
    from gymca_torch.parallel.spatial import gather_rows
    from gymca_torch.parallel.spatial_env import bulldozer_step_spatial, shard_state

    core = BulldozerCore(inp["size"], inp["size"], device="cpu")
    mesh = make_mesh(inp["devices"])
    state = shard_state(core.initial_state(_t(inp["keys"])), mesh)
    records = []
    for a in inp["actions"]:
        state, out = bulldozer_step_spatial(core, state, _t(a), mesh)
        records.append(_bulldozer_record(state, out,
                                         gather_rows(state.grid, mesh.get_group("data"), 1)))
    return records


def bulldozer_batched(inp):
    """``bulldozer_step_batched_spatial`` on a ``(data, space)`` mesh, the
    whole batch gathered after each step."""
    from gymca_torch.core.env import tree_map
    from gymca_torch.envs.bulldozer import BulldozerCore
    from gymca_torch.parallel.mesh import make_2d_mesh
    from gymca_torch.parallel.spatial import gather_rows
    from gymca_torch.parallel.spatial_env import (bulldozer_step_batched_spatial,
                                                  shard_state_batched)

    core = BulldozerCore(inp["size"], inp["size"], device="cpu")
    mesh = make_2d_mesh(*inp["mesh"])
    states = shard_state_batched(core.initial_state(_t(inp["keys"])), mesh)
    d = mesh.size(0)
    records = []
    for a in inp["actions"]:
        a = _t(a)
        per = a.shape[0] // d
        block = a[mesh.get_local_rank("data") * per:][:per]
        states, out = bulldozer_step_batched_spatial(core, states, block, mesh)
        whole = tree_map(lambda x: gather_rows(x, mesh.get_group("data")),
                         (out.reward, out.terminated, out.info["hit"], states.key))
        records.append({"grid": _np(_gather_2d(states.grid, mesh)),
                        **dict(zip(("reward", "done", "hit", "key"), map(_np, whole)))})
    return records


def _ca(inp):
    from gymca_torch.ops.alexandridis import AlexandridisCA

    return AlexandridisCA(inp["size"], 0, 1, 2, static_p_tree=0.0)


def _shared(inp):
    return {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in inp["shared"].items()}


def alexandridis(inp):
    """``alexandridis_step_spatial`` of one env on ``devices`` bands: the
    whole new grid and fire age."""
    from gymca_torch.parallel.mesh import make_mesh
    from gymca_torch.parallel.spatial import alexandridis_step_spatial, gather_rows, shard_rows

    mesh = make_mesh(inp["devices"])
    h = inp["grid"].shape[0]
    per_env = {k: shard_rows(_t(v), mesh, dim=-2 if k == "exp_slope" else 0)
               if np.ndim(v) >= 2 and (k == "exp_slope" or np.shape(v)[0] == h) else _t(v)
               for k, v in inp["per_env"].items()}
    grid, age = alexandridis_step_spatial(_ca(inp), shard_rows(_t(inp["grid"]), mesh),
                                          per_env, _shared(inp), _t(inp["key"]), mesh)
    g = mesh.get_group("data")
    return {"grid": _np(gather_rows(grid, g)), "fire_age": _np(gather_rows(age, g))}


def advanced(inp):
    """``advanced_step_spatial`` of each env of ``inp["envs"]`` on
    ``devices`` bands: whole grids and per-env entries, reward, done."""
    from gymca_torch.parallel.mesh import make_mesh
    from gymca_torch.parallel.spatial import gather_rows, shard_rows
    from gymca_torch.parallel.spatial_env import advanced_step_spatial

    mesh = make_mesh(inp["devices"])
    g = mesh.get_group("data")
    ca = _ca(inp)
    results = []
    for env in inp["envs"]:
        h = env["grid"].shape[0]
        per_env = {k: shard_rows(_t(v), mesh, dim=-2 if k == "exp_slope" else 0)
                   if np.ndim(v) >= 2 and (k == "exp_slope" or np.shape(v)[0] == h)
                   else _t(v) for k, v in env["per_env"].items()}
        grid, new, reward, done = advanced_step_spatial(
            ca, shard_rows(_t(env["grid"]), mesh), per_env, _shared(inp), _t(env["action"]),
            _t(env["key"]), mesh)
        results.append({
            "grid": _np(gather_rows(grid, g)),
            **{k: _np(gather_rows(new[k], g)) for k in ("fire_age", "dousing_count")},
            **{k: _np(new[k]) for k in ("time_step", "is_night", "position", "key")},
            "reward": _np(reward), "done": _np(done)})
    return results


def advanced_batched(inp):
    """``advanced_step_batched_spatial`` of the stacked envs of
    ``inp["envs"]`` on a ``(data, space)`` mesh."""
    from gymca_torch.parallel.mesh import make_2d_mesh, shard_env_batch
    from gymca_torch.parallel.spatial import gather_rows
    from gymca_torch.parallel.spatial_env import (advanced_step_batched_spatial,
                                                  shard_state_batched)

    mesh = make_2d_mesh(*inp["mesh"])
    envs = inp["envs"]
    grids = _t(np.stack([e["grid"] for e in envs]))
    per_envs = {k: _t(np.stack([e["per_env"][k] for e in envs])) for k in envs[0]["per_env"]}
    per_envs["true_grid"] = grids
    block = shard_state_batched(per_envs, mesh)
    rest = shard_env_batch(mesh, {"actions": _t(np.stack([e["action"] for e in envs])),
                                  "keys": _t(np.stack([e["key"] for e in envs]))})
    new_g, new, rewards, dones = advanced_step_batched_spatial(
        _ca(inp), block["true_grid"], block, _shared(inp), rest["actions"], rest["keys"], mesh)
    data = mesh.get_group("data")
    return {"grid": _np(_gather_2d(new_g, mesh)),
            **{k: _np(_gather_2d(new[k], mesh)) for k in ("fire_age", "dousing_count")},
            **{k: _np(gather_rows(new[k], data)) for k in ("time_step", "position", "key")},
            "reward": _np(gather_rows(rewards, data)), "done": _np(gather_rows(dones, data))}


def env_batch(inp):
    """``shard_env_batch`` of the Advanced env's reset on ``devices`` ranks:
    this rank's shapes and whether each leaf is its block of the whole."""
    from gymca_torch import rng
    from gymca_torch.core.env import tree_map
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv
    from gymca_torch.parallel.mesh import make_mesh, shard_env_batch

    env = AdvancedForestFireBulldozerEnv(inp["size"], inp["size"], key=rng.key(0, "cpu"),
                                         num_envs=inp["num_envs"], device="cpu")
    obs, info = env.reset()
    mesh = make_mesh(inp["devices"])
    per = inp["num_envs"] // inp["devices"]
    lo = mesh.get_local_rank("data") * per
    rgb, keys = shard_env_batch(mesh, (obs[0], obs[1]["per_env_context"]["key"]))
    scalar = shard_env_batch(mesh, obs[1]["shared_context"]["p_fire"])
    blocks = tree_map(lambda x, y: bool(torch.equal(x, y[lo:lo + per])),
                      shard_env_batch(mesh, info), info)
    return {"rgb_shape": tuple(rgb.shape), "rgb": bool(torch.equal(rgb, obs[0][lo:lo + per])),
            "keys": bool(torch.equal(keys, obs[1]["per_env_context"]["key"][lo:lo + per])),
            "scalar_kept": scalar is obs[1]["shared_context"]["p_fire"], "info": blocks}


# --- the bench's sharded windy runs ---------------------------------------------------------


def bench_windy(inp):
    """``gymca_torch.bench.measure_windy`` on every rank of the world, with
    ``GYMCA_BENCH_SHARD=inp["shard"]``, its stderr captured and the envs each
    K1 call steps counted where ``envs.bulldozer`` calls it.  The last run's
    end states gathered over the ranks when the batch was sharded, and, on
    rank 0, the same run made alone (no group) on the same envs."""
    import contextlib
    import io

    import torch.distributed as dist

    import gymca_torch.envs.bulldozer as bulldozer
    from gymca_torch import bench
    from gymca_torch.core.env import tree_map
    from gymca_torch.parallel.spatial import gather_rows

    size, envs, steps = inp["size"], inp["envs"], inp["steps"]
    core = bulldozer.BulldozerCore(size, size, device="cpu")
    calls, real = [], bulldozer.windy_fused_step

    def counted(*args, **kw):
        calls.append(int(args[0].shape[0]))
        return real(*args, **kw)

    err = io.StringIO()
    bulldozer.windy_fused_step = counted
    os.environ["GYMCA_BENCH_SHARD"] = inp["shard"]
    try:
        with contextlib.redirect_stderr(err):
            out = bench.measure_windy(size, envs, steps, "cpu", dist.group.WORLD)
            sharded = bench.windy_shard(envs, dist.group.WORLD) is None
    finally:
        bulldozer.windy_fused_step = real
        del os.environ["GYMCA_BENCH_SHARD"]
    res = {"stderr": err.getvalue(), "calls": calls, "returned": out is not None}
    if out is None:
        return res
    last = out["runs"][-1]
    states = last["states"]
    if sharded:
        states = tree_map(lambda x: gather_rows(x, None), states)
    res.update(states=states, grid=core.materialize_grid(states),
               reward_sums=last["reward_sums"], done_fraction=out["done_fraction"],
               value=out["value"], seconds=[r["seconds"] for r in out["runs"]],
               own_seconds=[r["own_seconds"] for r in out["runs"]])
    if dist.get_rank() == 0:
        alone = bench.measure_windy(size, envs, steps, "cpu")["runs"][-1]
        res.update(alone_states=alone["states"], alone_grid=core.materialize_grid(alone["states"]),
                   alone_reward_sums=alone["reward_sums"])
    return res


# --- multi-host ---------------------------------------------------------------------------


def multihost(inp):
    """``tests/multihost_worker.py`` on the port: a ``(host, device)`` mesh
    from ``LOCAL_WORLD_SIZE``, a sum over both axes, a Bulldozer batch cut
    over the ranks against the unsharded step, and the coordinator."""
    import torch.distributed as dist

    from gymca_torch import rng
    from gymca_torch.envs.bulldozer import BulldozerCore
    from gymca_torch.parallel.mesh import (is_coordinator, make_host_device_mesh, make_mesh,
                                           shard_env_batch)

    mesh2 = make_host_device_mesh()
    x = torch.tensor([float(dist.get_rank())])
    dist.all_reduce(x, group=mesh2.get_group("device"))
    dist.all_reduce(x, group=mesh2.get_group("host"))

    core = BulldozerCore(16, 16, device="cpu")
    states = core.initial_state(rng.split(rng.key(7, "cpu"), 8))
    actions = torch.tensor([[1, 1]] * 8, dtype=torch.int32)
    s2, out = core.step(states, actions)
    expect = (float(out.reward.sum()), int((s2.grid == core._tree).sum()))

    mesh1 = make_mesh()
    s2, out = core.step(shard_env_batch(mesh1, states), shard_env_batch(mesh1, actions))
    got = torch.stack([out.reward.sum().double(), (s2.grid == core._tree).sum().double()])
    dist.all_reduce(got)
    return {"mesh": dict(zip(mesh2.mesh_dim_names, mesh2.shape)), "sum_hd": float(x),
            "coordinator": is_coordinator(), "reward_sum": float(got[0]),
            "tree_total": int(got[1]), "expect": expect}


def backend_checks(inp):
    """``initialize_distributed`` on the running gloo group: asked for the
    CPU it does nothing; asked for the card it raises."""
    from gymca_torch.parallel.mesh import initialize_distributed

    out = {"cpu": initialize_distributed(device="cpu")}
    try:
        initialize_distributed(device="cuda")
        out["cuda"] = "no error"
    except RuntimeError as e:
        out["cuda"] = {"raised": "RuntimeError", "message": str(e)}
    return out


def uneven_hosts(inp):
    from gymca_torch.parallel.mesh import make_host_device_mesh

    os.environ["LOCAL_WORLD_SIZE"] = str(inp["local_world_size"])
    make_host_device_mesh()
    return "no error"


# --- data-parallel PPO ---------------------------------------------------------------------


def _ppo_env_args(inp):
    from gymca_torch.agents import args as targs
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv

    e = inp["env"]
    env = AdvancedForestFireBulldozerEnv(e["size"], e["size"], key=e["key"],
                                         num_envs=e["num_envs"], terrain=e["terrain"],
                                         device="cpu")
    a = inp["args"]
    exp = dict(a["exp"])
    args = targs.Args(ppo=targs.PPOArgs(**a["ppo"]), env=targs.EnvArgs(**a["env"]),
                      viz=targs.VisualizationArgs(), exp=targs.ExperimentArgs(**exp))
    return env, args


def _dp(inp):
    from gymca_torch.agents import optim
    from gymca_torch.parallel.mesh import make_mesh
    from gymca_torch.parallel.sharded import DataParallelPPO

    env, args = _ppo_env_args(inp)
    dp = DataParallelPPO(env, args, make_mesh(inp["devices"]), key=inp["key"], device="cpu")
    if inp.get("params") is not None:
        params = inp["params"]
        dp.trainer.agent_state = dp.trainer.agent_state.replace(
            params=params, opt_state=optim.adam_init(params, args.ppo.learning_rate))
    return dp


def _params_np(state):
    return {g: {k: _np(v) for k, v in d.items()} for g, d in state.params.items()}


def dp_iteration(inp):
    """One ``train_iteration`` of ``DataParallelPPO`` on ``devices`` ranks:
    metrics, params, the all-reduce counts; with ``single`` also the
    port's ``PPOTrainer`` from the same key, weights and env."""
    from gymca_torch import rng
    from gymca_torch.agents.ppo import EpisodeStatistics, PPOTrainer

    dp = _dp(inp)
    out = dp.train_iteration(*dp.init_carry())
    res = {"metrics": {k: float(v) for k, v in out[-1].items()},
           "params": _params_np(out[0]), "grad_all_reduces": dp.trainer.grad_all_reduces,
           "metric_all_reduces": dp.metric_all_reduces, "step": int(out[0].step)}
    if inp.get("single"):
        env, args = _ppo_env_args(inp)
        tr = PPOTrainer(env, args, inp["key"], device="cpu")
        tr.agent_state = tr.agent_state.replace(params=dp.trainer.agent_state.params,
                                                opt_state=dp.trainer.agent_state.opt_state)
        obs, info = env.reset()
        n = args.env.num_envs
        single = tr.train_iteration(tr.agent_state, EpisodeStatistics.create(n, "cpu"), obs,
                                    torch.zeros(n, dtype=torch.bool), info,
                                    rng.split(tr.key, 1)[0])
        res["single_metrics"] = {k: float(v) for k, v in single[-1].items()}
        res["single_params"] = _params_np(single[0])
        res["metrics_bits"] = all(torch.equal(out[-1][k], single[-1][k].to(torch.float32))
                                  for k in single[-1])
    return res


def dp_train(inp):
    """``iterations`` train iterations: each one's metrics."""
    dp = _dp(inp)
    carry = dp.init_carry()
    hist = []
    for _ in range(inp["iterations"]):
        *carry, metrics = dp.train_iteration(*carry)
        hist.append({k: float(v) for k, v in metrics.items()})
    return hist


def dp_kickstart(inp):
    """A critic-warmup iteration then a kickstart iteration: whether torso
    and actor stayed bit for bit, the critic moved, and the metrics."""
    dp = _dp(inp)
    assert dp._iter_ks is not None and dp._iter_warmup is not None
    carry = dp.init_carry()
    st0 = carry[0]
    *carry, _ = dp._iter_warmup(*carry, 1.0)
    st1 = carry[0]

    def same(sub):
        return all(torch.equal(st0.params[sub][k], st1.params[sub][k]) for k in st0.params[sub])

    *carry, metrics = dp._iter_ks(*carry, 0.5)
    return {"network": same("network_params"), "actor": same("actor_params"),
            "critic": same("critic_params"),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def dp_plain(inp):
    dp = _dp(inp)
    return {"ks": dp._iter_ks is None, "warmup": dp._iter_warmup is None}
