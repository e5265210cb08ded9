"""The port's spatial steps (``gymca_torch.parallel``) against the JAX
package's, on the CPU.

The port's ranks are spawned gloo processes (``tests/torch_parallel_ranks.py``):
one world of 2, one of 4 and one of 8 ranks per module, each running every
case of its size and writing back the whole grids (gathered from the
bands).  The JAX side runs here, on conftest's 8 virtual devices, from the
same inputs: grids and actions from numpy seeds, keys as jax key data.
Every comparison is bit for bit (tolerance 0): the spatial steps draw from
the same key chain as the single-device steps, and the Alexandridis bands
from the same shard-folded keys as the JAX package on a mesh of the same
size.  The JAX functions are jitted once per shape and mesh (eager, each
case cost half a minute of op-by-op compiles).  The same worlds run
``gymca_torch.bench``'s windy measure sharded over their ranks, against
bench.py's sharded branch on as many virtual devices.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymca_torch import bench
from gymca_torch.envs.bulldozer import BulldozerCore as TCore
from gymca_torch.ops.alexandridis import AlexandridisCA as TCA
from gymca_torch.ops.windy import windy_step as t_windy_step
from gymca_tpu.envs.bulldozer import BulldozerCore as JCore
from gymca_tpu.envs.terrain import get_winds
from gymca_tpu.ops.alexandridis import AlexandridisCA as JCA
from gymca_tpu.ops.windy import windy_step as j_windy_step
from gymca_tpu.parallel.mesh import make_2d_mesh, make_mesh
from gymca_tpu.parallel.spatial import alexandridis_step_spatial as j_alex_spatial
from gymca_tpu.parallel.spatial import windy_step_spatial as j_windy_spatial
from gymca_tpu.parallel.spatial_env import (advanced_step_batched_spatial,
                                            advanced_step_spatial,
                                            bulldozer_step_batched_spatial,
                                            bulldozer_step_spatial, shard_state)
from test_torch_bulldozer import assert_states_equal
from torch_parallel_ranks import run_world

EMPTY, TREE, FIRE = 0, 3, 25
A_TREE, A_FIRE = 1, 2  # the Alexandridis cells (empty 0)
H, W = 32, 16  # tests/test_spatial_alexandridis.py's grid
BULL_SIZE, BULL_STEPS, BATCH_ENVS, BATCH_STEPS = 64, 16, 4, 15
MESHES = [(2, 2), (1, 4), (4, 1)]
BENCH = {"size": 48, "envs": 8, "steps": 8}  # 48²: one CA period a step at most
# Per-step reward sums: float32 sums over the envs in another order than
# XLA's (and, sharded, over the ranks), of rewards in [-1, 0].
REWARD_RTOL, REWARD_ATOL = 1e-6, 1e-6


def kd(k):
    """jax key -> the port's key data (int64 words)."""
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def wrap(d):
    return jax.random.wrap_key_data(jnp.asarray(np.asarray(d, np.uint32)))


# --- inputs ------------------------------------------------------------------------------


def windy_case(devices):
    grid = np.random.default_rng(devices).choice(
        np.asarray([EMPTY, TREE, FIRE], np.int32), (64, 16))
    wind = np.full((3, 3), 0.6, np.float32)
    wind[1, 1] = 0.0
    return {"devices": devices, "grid": grid, "wind": wind,
            "keys": [kd(jax.random.fold_in(jax.random.key(42), 3))],
            "empty": EMPTY, "tree": TREE, "fire": FIRE}


def seam_case():
    grid = np.full((32, 16), TREE, np.int32)
    grid[0, 8] = FIRE
    wind = np.ones((3, 3), np.float32)
    wind[1, 1] = 0.0
    return {"devices": 4, "grid": grid, "wind": wind,
            "keys": [kd(jax.random.fold_in(jax.random.key(42), i)) for i in range(12)],
            "empty": EMPTY, "tree": TREE, "fire": FIRE}


def actions(seed, steps, n=None):
    r = np.random.default_rng(seed)
    shape = (steps,) if n is None else (steps, n)
    return np.stack([r.integers(0, 9, shape), r.integers(0, 2, shape)], -1).astype(np.int32)


def bulldozer_case(devices):
    return {"devices": devices, "size": BULL_SIZE, "keys": kd(jax.random.key(42))[None],
            "actions": actions(devices, BULL_STEPS)[:, None]}


def batched_case(mesh):
    return {"mesh": mesh, "size": BULL_SIZE,
            "keys": kd(jax.random.split(jax.random.key(42), BATCH_ENVS)),
            "actions": actions(7, BATCH_STEPS, BATCH_ENVS)}


def alex_ctx(grid, wind_scale, **mod):
    """``tests/test_spatial_alexandridis.py``'s ``make_ctx`` in numpy."""
    h, w = grid.shape
    per_env = {
        "wind_index": np.asarray(0, np.int32),
        "density": np.full((h, w), 3, np.int32),
        "vegetation": np.full((h, w), 3, np.int32),
        "altitude": np.zeros((h, w), np.float32),
        "slope": np.zeros((h, w, 3, 3), np.float32),
        "exp_slope": np.ones((3, 3, h, w), np.float32),
        "veg_den_factor": np.full((h, w), 2.0, np.float32),
        "fire_age": np.where(grid == A_FIRE, 50.0, 0.0).astype(np.float32),
        "dousing_count": np.zeros((h, w), np.int32),
        "is_night": np.asarray(0, np.int32),
        "true_grid": grid,
        "time_step": np.asarray(1, np.int32),
    }
    per_env.update(mod)
    shared = {"winds": np.full((8, 3, 3), wind_scale, np.float32),
              "fts": np.ones((8, 3, 3), np.float32),
              "p_fire": np.asarray(0.0, np.float32), "p_tree": np.asarray(0.0, np.float32),
              "p_wind_change": np.asarray(0.0, np.float32), "day_length": 400}
    return per_env, shared


def fire_at(r, c, h=H, w=W):
    g = np.full((h, w), A_TREE, np.int32)
    g[r, c] = A_FIRE
    return g


def random_alex_grid():
    r = np.random.default_rng(11)
    grid = r.choice(np.asarray([0, A_TREE, A_FIRE], np.int32), (H, W), p=(0.1, 0.75, 0.15))
    return grid, {"fire_age": np.where(grid == A_FIRE, r.uniform(1, 60, (H, W)), 0.0
                                       ).astype(np.float32),
                  "dousing_count": (r.uniform(size=(H, W)) < 0.1).astype(np.int32)}


def alex_cases():
    """(name, devices, size, grid, wind scale, per-env overrides)."""
    dousing = np.zeros((H, W), np.int32)
    dousing[H // 4 - 2:H // 4] = 1
    tiny_dousing = np.zeros((8, 8), np.int32)
    tiny_dousing[2] = 1
    burn = fire_at(15, 8)
    grid, mod = random_alex_grid()
    cases = [(f"ignition{d}", d, H, fire_at(H // d, 8), 1e6, {}) for d in (2, 4)]
    cases += [(f"fixpoint{d}", d, H, fire_at(5, 8), 0.0, {}) for d in (2, 4)]
    cases += [("burnout", 4, H, burn, 0.0,
               {"fire_age": np.where(burn == A_FIRE, 1.0, 0.0).astype(np.float32)}),
              ("douse_all", 4, H, fire_at(H // 4, 8), 1.0,
               {"dousing_count": np.ones((H, W), np.int32)}),
              ("douse_seam", 4, H, fire_at(H // 4, 8), 1e6, {"dousing_count": dousing}),
              ("tiny", 2, 8, fire_at(4, 4, 8, 8), 1e6, {"dousing_count": tiny_dousing}),
              ("random", 2, H, grid, 10.0, mod)]
    return cases


def alex_input(devices, size, grid, wind, mod, key_seed=42):
    per_env, shared = alex_ctx(grid, wind, **mod)
    return {"devices": devices, "size": size, "grid": grid, "per_env": per_env,
            "shared": shared, "key": kd(jax.random.key(key_seed))}


def advanced_envs():
    """``tests/test_spatial_env.py``'s two Advanced envs at 32², with the
    packaged winds."""
    winds, fts = (np.asarray(x, np.float32) for x in get_winds(True))
    keys = jax.random.split(jax.random.key(42), 2)
    envs = []
    for i, action in enumerate(([4, 1], [1, 0])):
        grid = np.full((32, 32), A_TREE, np.int32)
        grid[16, 16 + i] = A_FIRE
        per_env, _ = alex_ctx(grid, 0.0)
        per_env.update(altitude=np.zeros((32, 32), np.float32),
                       slope=np.zeros((32, 32, 3, 3), np.float32),
                       position=np.asarray([4, 7 + i], np.int32))
        envs.append({"grid": grid, "per_env": per_env, "action": np.asarray(action, np.int32),
                     "key": kd(keys[i])})
    shared = {"winds": winds, "fts": fts, "p_fire": np.asarray(0.0, np.float32),
              "p_tree": np.asarray(0.0, np.float32),
              "p_wind_change": np.asarray(0.0, np.float32), "day_length": 400}
    return envs, shared


ADV_ENVS, ADV_SHARED = advanced_envs()
ALEX = {name: (d, alex_input(d, size, grid, wind, mod))
        for name, d, size, grid, wind, mod in alex_cases()}


def cases_for(world):
    cases = [(f"windy{world}", "windy", windy_case(world))]
    if world == 8:
        return cases + [("rows", "rows_not_divisible", {"devices": 8, "shape": (30, 16)})]
    cases.append((f"bulldozer{world}", "bulldozer", bulldozer_case(world)))
    cases.append((f"bench{world}", "bench_windy", {**BENCH, "shard": "1"}))
    cases.append((f"bench_whole{world}", "bench_windy",
                  {**BENCH, "shard": "0"} if world == 2 else {**BENCH, "envs": 6, "shard": "1"}))
    cases += [(name, "alexandridis", inp) for name, (d, inp) in ALEX.items() if d == world]
    if world == 2:
        cases.append(("advanced", "advanced", {"devices": 2, "size": 32, "envs": ADV_ENVS,
                                               "shared": ADV_SHARED}))
    if world == 4:
        cases.append(("seam", "windy", seam_case()))
        cases += [(f"batched{m}", "bulldozer_batched", batched_case(m)) for m in MESHES]
        cases.append(("advanced_batched", "advanced_batched",
                      {"mesh": (2, 2), "size": 32, "envs": ADV_ENVS, "shared": ADV_SHARED}))
        cases.append(("env_batch", "env_batch", {"devices": 4, "size": 16, "num_envs": 4}))
    return cases


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``world(n)``: every rank's results of the world of ``n`` ranks, run
    once per module."""
    runs = {}

    def get(n):
        if n not in runs:
            runs[n] = run_world(n, cases_for(n), tmp_path_factory.mktemp(f"world{n}"))
        return runs[n]

    return get


def rank0(world, n, name):
    res = world(n)[0][name]
    assert not (isinstance(res, dict) and "raised" in res), res
    return res


# --- the windy step ---------------------------------------------------------------------


WINDY_KW = dict(empty=EMPTY, tree=TREE, fire=FIRE)
j_windy_single = jax.jit(functools.partial(j_windy_step, **WINDY_KW))


@functools.lru_cache(maxsize=None)
def j_windy_sharded(devices):
    mesh = make_mesh(devices)
    return jax.jit(lambda g, w, k: j_windy_spatial(g, w, k, mesh, **WINDY_KW))


@pytest.mark.parametrize("devices", [2, 4, 8])
def test_windy_spatial_matches_jax_and_the_single_device_step(world, devices):
    case = windy_case(devices)
    (got,) = rank0(world, devices, f"windy{devices}")
    k = wrap(case["keys"][0])
    want_sharded = j_windy_sharded(devices)(jnp.asarray(case["grid"]),
                                            jnp.asarray(case["wind"]), k)
    want_single = j_windy_single(jnp.asarray(case["grid"]), jnp.asarray(case["wind"]), k)
    port_single = t_windy_step(torch.tensor(case["grid"])[None], torch.tensor(case["wind"]),
                               torch.tensor(case["keys"][0])[None], empty=EMPTY, tree=TREE,
                               fire=FIRE)[0]
    np.testing.assert_array_equal(got, np.asarray(want_sharded))
    np.testing.assert_array_equal(got, np.asarray(want_single))
    np.testing.assert_array_equal(got, port_single.numpy())
    assert (got != case["grid"]).any()


def test_windy_fire_crosses_band_seams(world):
    """12 steps with every gust on: the front leaves row 0 and crosses the
    seam at row 8 (bands of 8 rows), each step equal to the JAX sharded and
    single-device steps."""
    case = seam_case()
    got = rank0(world, 4, "seam")
    g_single = g_shard = jnp.asarray(case["grid"])
    for i, k in enumerate(case["keys"]):
        g_single = j_windy_single(g_single, jnp.asarray(case["wind"]), wrap(k))
        g_shard = j_windy_sharded(4)(g_shard, jnp.asarray(case["wind"]), wrap(k))
        np.testing.assert_array_equal(got[i], np.asarray(g_single), err_msg=f"step {i}")
        np.testing.assert_array_equal(got[i], np.asarray(g_shard), err_msg=f"step {i}")
    assert (got[-1][9:13] != TREE).any()


def test_grid_rows_not_divisible_raise(world):
    for res in world(8):
        assert res["rows"]["raised"] == "ValueError", res["rows"]


# --- the Bulldozer steps ------------------------------------------------------------------


BULL_LEAVES = ("reward", "done", "hit", "key", "position", "time", "tree_count",
               "fire_count", "steps_elapsed", "reward_accumulated")


@pytest.mark.parametrize("devices", [2, 4])
def test_bulldozer_spatial_matches_jax_and_core_step(world, devices):
    """16 steps of one 64² env on ``devices`` bands: every leaf equal to the
    JAX ``bulldozer_step_spatial`` and to the port's ``BulldozerCore.step``
    of the whole grid, bit for bit."""
    case = bulldozer_case(devices)
    got = rank0(world, devices, f"bulldozer{devices}")
    jcore = JCore(BULL_SIZE, BULL_SIZE)
    mesh = make_mesh(devices)
    j_state = shard_state(jcore.initial_state(jax.random.key(42)), mesh)
    j_step = jax.jit(lambda s, a: bulldozer_step_spatial(jcore, s, a, mesh))
    tcore = TCore(BULL_SIZE, BULL_SIZE, device="cpu")
    t_state = tcore.initial_state(torch.tensor(case["keys"]))
    for i, (a, rec) in enumerate(zip(case["actions"], got)):
        j_state, j_out = j_step(j_state, jnp.asarray(a[0]))
        t_state, t_out = tcore.step(t_state, torch.tensor(a))
        want = {"grid": j_state.grid[None], "reward": j_out.reward[None],
                "done": j_out.terminated[None], "hit": j_out.info["hit"][None],
                "key": jax.random.key_data(j_state.key)[None],
                "position": j_state.context["position"][None],
                "time": j_state.context["time"][None],
                "tree_count": j_state.context["tree_count"][None],
                "fire_count": j_state.context["fire_count"][None],
                "steps_elapsed": j_state.steps_elapsed[None],
                "reward_accumulated": j_state.reward_accumulated[None]}
        port = {"grid": t_state.grid, "reward": t_out.reward, "done": t_out.terminated,
                "hit": t_out.info["hit"], "key": t_state.key, **{
                    k: t_state.context[k] for k in ("position", "time", "tree_count",
                                                   "fire_count")},
                "steps_elapsed": t_state.steps_elapsed,
                "reward_accumulated": t_state.reward_accumulated}
        for k in ("grid",) + BULL_LEAVES:
            w = np.asarray(want[k])
            w = w.astype(np.int64) if k == "key" else w
            np.testing.assert_array_equal(rec[k], w, err_msg=f"step {i} {k} (JAX)")
            np.testing.assert_array_equal(rec[k], port[k].numpy(), err_msg=f"step {i} {k}")
    assert int(got[-1]["steps_elapsed"][0]) == BULL_STEPS
    assert (got[-1]["grid"] != got[0]["grid"]).any()


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_bulldozer_batched_spatial_matches_jax_on_every_mesh(world, mesh_shape):
    """4 envs of 64² for 15 steps on a ``(data, space)`` mesh: grids,
    rewards, dones, hits and keys equal to the JAX function on the same mesh
    shape and to the port on the other shapes (shard-count invariance), bit
    for bit."""
    case = batched_case(mesh_shape)
    got = rank0(world, 4, f"batched{mesh_shape}")
    jcore = JCore(BULL_SIZE, BULL_SIZE)
    mesh = make_2d_mesh(*mesh_shape)
    states = jax.vmap(jcore.initial_state)(jax.random.split(jax.random.key(42), BATCH_ENVS))
    step = jax.jit(lambda s, a: bulldozer_step_batched_spatial(jcore, s, a, mesh))
    for i, (a, rec) in enumerate(zip(case["actions"], got)):
        states, out = step(states, jnp.asarray(a))
        want = {"grid": states.grid, "reward": out.reward, "done": out.terminated,
                "hit": out.info["hit"],
                "key": np.asarray(jax.random.key_data(states.key)).astype(np.int64)}
        for k, v in want.items():
            np.testing.assert_array_equal(rec[k], np.asarray(v), err_msg=f"step {i} {k}")
    for other in MESHES:
        for i, (a, b) in enumerate(zip(got, rank0(world, 4, f"batched{other}"))):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{other} step {i} {k}")


# --- the bench's sharded branch -----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_bench_sharded(n_dev):
    """bench.py:44-52 and :75-116 with ``step = jax.vmap(core.step)``, which
    the fused step equals bit for bit (``tests/test_pallas.py``), on
    ``n_dev`` of conftest's virtual devices where bench.py takes every
    device it sees: the reset states and the jitted run, which returns the
    end states beside the reward sums."""
    from jax.sharding import PartitionSpec as P

    from gymca_tpu.parallel.mesh import make_mesh as j_make_mesh
    from gymca_tpu.parallel.mesh import shard_env_batch
    from gymca_tpu.parallel.sharded import shard_map

    size, num_envs, steps = BENCH["size"], BENCH["envs"], BENCH["steps"]
    core = JCore(size, size)
    key = jax.random.key(0)
    keys = jax.random.split(key, num_envs)
    states = jax.vmap(core.initial_state)(keys)
    step = jax.vmap(core.step)

    # bench.py:78-96, n_dev given
    assert num_envs % n_dev == 0
    mesh = j_make_mesh(n_dev)
    states = shard_env_batch(mesh, states)
    inner = step
    out_struct = jax.eval_shape(
        inner, states, jnp.zeros((num_envs, 2), jnp.int32)
    )
    step = shard_map(
        inner, mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P("data"), states), P("data")),
        out_specs=jax.tree.map(lambda _: P("data"), out_struct),
    )

    def body(carry, _):
        states, key = carry
        key, k_act = jax.random.split(key)
        actions = jax.random.randint(k_act, (num_envs, 2), 0, 2, dtype=jnp.int32)
        actions = actions.at[:, 0].set(
            jax.random.randint(jax.random.fold_in(k_act, 1), (num_envs,), 0, 9)
        )
        states, out = step(states, actions)
        return (states, key), out.reward.sum()

    @jax.jit
    def run(states, key):
        (states, _), rewards = jax.lax.scan(body, (states, key), None, length=steps)
        return states, rewards

    return run(states, jax.random.fold_in(key, 2 + bench.REPS - 1))  # the last run


def assert_alone_equal(got, n):
    """Rank 0's run of the world equals its run alone on the same envs."""
    assert got["states"].grid.shape[0] == got["alone_states"].grid.shape[0] == n
    for k in ("grid", "key", "done", "steps_elapsed", "reward_accumulated"):
        assert torch.equal(getattr(got["states"], k), getattr(got["alone_states"], k)), k
    for k, v in got["alone_states"].context.items():
        assert torch.equal(got["states"].context[k], v), k
    assert torch.equal(got["grid"], got["alone_grid"])


@pytest.mark.parametrize("devices", [2, 4])
def test_bench_sharded_windy_run_matches_bench_pys_sharded_branch(world, devices):
    """``measure_windy`` over ``devices`` gloo ranks, 8 envs of 48², 8 steps:
    each rank steps its 8/d envs through K1's wrapper in every run, and the
    last run's states gathered from the ranks equal bench.py's sharded
    branch on as many devices in every leaf, bit for bit after
    ``materialize_grid``, and the port's run of the 8 envs alone; the
    reward sums over the ranks are within ``REWARD_RTOL``; rank 0 says that
    it shards."""
    n, steps, per = BENCH["envs"], BENCH["steps"], BENCH["envs"] // devices
    ranks = world(devices)
    got = rank0(world, devices, f"bench{devices}")
    for r in ranks:
        b = r[f"bench{devices}"]
        assert b["calls"] == [per] * (bench.WARM + bench.REPS) * steps
        assert b["seconds"] == got["seconds"] and b["done_fraction"] == got["done_fraction"]
        assert all(s >= o for s, o in zip(b["seconds"], b["own_seconds"]))
    assert f"[rank 0] [bench] sharding {n} envs over {devices} ranks ({per} a rank)" in \
        got["stderr"]
    j_end, j_rewards = jax_bench_sharded(devices)
    assert_states_equal(got["states"], j_end, grid=got["grid"], msg=f"{devices} ranks")
    assert_alone_equal(got, n)
    np.testing.assert_allclose(got["reward_sums"].numpy(), np.asarray(j_rewards),
                               rtol=REWARD_RTOL, atol=REWARD_ATOL)
    np.testing.assert_allclose(got["reward_sums"].numpy(), got["alone_reward_sums"].numpy(),
                               rtol=REWARD_RTOL, atol=REWARD_ATOL)
    assert got["done_fraction"] == float(np.asarray(j_end.done).mean())
    assert got["value"] == n * steps / min(got["seconds"][bench.WARM:])


@pytest.mark.parametrize("devices,why", [(2, "GYMCA_BENCH_SHARD=0"),
                                         (4, "6 envs do not divide over 4 ranks")])
def test_bench_unsharded_batch_runs_whole_on_rank_0(world, devices, why):
    """``GYMCA_BENCH_SHARD=0`` on 2 ranks, and 6 envs on 4: rank 0 steps the
    whole batch, equal to its run alone, and says why; the other ranks step
    nothing and return at once."""
    ranks = world(devices)
    got = rank0(world, devices, f"bench_whole{devices}")
    n = got["states"].grid.shape[0]
    assert got["calls"] == [n] * (bench.WARM + bench.REPS) * BENCH["steps"]
    assert f"[rank 0] [bench] not sharding ({why}): rank 0 steps all {n} envs" in got["stderr"]
    assert "sharding" not in got["stderr"].replace("not sharding", "")
    assert_alone_equal(got, n)
    for r in ranks[1:]:
        b = r[f"bench_whole{devices}"]
        assert not b["returned"] and b["calls"] == [] and b["stderr"] == ""


# --- the Alexandridis steps -----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jca_of(size):
    return JCA(size, 0, A_TREE, A_FIRE, static_p_tree=0.0)


@functools.lru_cache(maxsize=None)
def j_alex_sharded(size, devices):
    mesh = make_mesh(devices)
    return jax.jit(lambda g, pe, sh, k: j_alex_spatial(jca_of(size), g, pe, sh, k, mesh))


@functools.lru_cache(maxsize=None)
def j_alex_single(size):
    return jax.jit(lambda g, pe, sh, k: jca_of(size).update(g, None, (pe, sh), k))


def j_shared(shared):
    """The shared context with ``day_length`` static, as the env holds it."""
    arrays = {k: jnp.asarray(v) for k, v in shared.items() if isinstance(v, np.ndarray)}
    return arrays, {k: v for k, v in shared.items() if k not in arrays}


def alex_both(name):
    """(JAX on the same mesh, JAX single device, port single device) of an
    Alexandridis case: each (grid, fire age)."""
    devices, inp = ALEX[name]
    per_env = {k: jnp.asarray(v) for k, v in inp["per_env"].items()}
    per_env["key"] = jax.random.key(0)
    arrays, static = j_shared(inp["shared"])
    assert static == {"day_length": 400}
    key = wrap(inp["key"])
    grid = jnp.asarray(inp["grid"])
    sharded = j_alex_sharded(inp["size"], devices)(grid, per_env, arrays, key)
    single_g, (single_pe, _) = j_alex_single(inp["size"])(grid, dict(per_env), arrays, key)
    tca = TCA(inp["size"], 0, A_TREE, A_FIRE, static_p_tree=0.0)
    t_pe = {k: torch.tensor(v)[None] for k, v in inp["per_env"].items()}
    t_shared = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
                for k, v in inp["shared"].items()}
    t_g, (t_new, _) = tca.update(torch.tensor(inp["grid"])[None], None, (t_pe, t_shared),
                                 torch.tensor(inp["key"])[None])
    return ((np.asarray(sharded[0]), np.asarray(sharded[1])),
            (np.asarray(single_g), np.asarray(single_pe["fire_age"])),
            (t_g[0].numpy(), t_new["fire_age"][0].numpy()))


@pytest.mark.parametrize("name", sorted(ALEX))
def test_alexandridis_spatial_matches_jax(world, name):
    """Grid and fire age after one sharded step equal the JAX package's
    ``alexandridis_step_spatial`` on a mesh of the same size, bit for bit,
    draws included ("random": 15% fire, 10% dousing, a wind at which some of
    the trees beside a fire ignite and some do not)."""
    devices, _ = ALEX[name]
    got = rank0(world, devices, name)
    (jg, ja), _, _ = alex_both(name)
    np.testing.assert_array_equal(got["grid"], jg)
    np.testing.assert_array_equal(got["fire_age"], ja)
    if name == "random":  # some trees beside a fire ignited by their draws, some not
        before = ALEX[name][1]["grid"]
        fire = np.pad(before == A_FIRE, 1)
        near = sum(fire[1 + dr:1 + dr + H, 1 + dc:1 + dc + W]
                   for dr in (-1, 0, 1) for dc in (-1, 0, 1) if dr or dc) > 0
        candidates = (before == A_TREE) & near
        lit = candidates & (got["grid"] == A_FIRE)
        assert 0 < lit.sum() < candidates.sum(), (lit.sum(), candidates.sum())


@pytest.mark.parametrize("name", ["ignition2", "ignition4"])
def test_certain_ignition_across_band_seams(world, name):
    """Fire on a band's first row, ignition certain: the sharded grid equals
    the single-device CA (JAX's and the port's) and all 9 cells around the
    seam burn."""
    devices, inp = ALEX[name]
    got = rank0(world, devices, name)
    _, (jg, _), (tg, _) = alex_both(name)
    np.testing.assert_array_equal(got["grid"], jg)
    np.testing.assert_array_equal(got["grid"], tg)
    band = H // devices
    assert (got["grid"][band - 1:band + 2, 7:10] == A_FIRE).sum() == 9


@pytest.mark.parametrize("name", ["fixpoint2", "fixpoint4", "burnout", "douse_all",
                                  "douse_seam", "tiny"])
def test_rng_independent_outcomes_equal_the_single_device_ca(world, name):
    """``tests/test_spatial_alexandridis.py``'s contracts: zero wind is a
    fixpoint (ages too), a fire of age 1 burns out, dousing everywhere
    blocks, dousing in the band above blocks across the seam, and the halo
    is at least 2 rows on a tiny grid whose heat radius is 1."""
    devices, inp = ALEX[name]
    got = rank0(world, devices, name)
    _, (jg, ja), (tg, ta) = alex_both(name)
    np.testing.assert_array_equal(got["grid"], jg)
    np.testing.assert_array_equal(got["grid"], tg)
    if name.startswith("fixpoint"):
        np.testing.assert_array_equal(got["fire_age"], ja)
        np.testing.assert_array_equal(got["fire_age"], ta)
    if name == "burnout":
        assert got["grid"][15, 8] == 0
    if name in ("douse_all", "douse_seam"):
        assert (got["grid"] == A_FIRE).sum() == 1
    if name == "tiny":
        assert TCA(8, 0, A_TREE, A_FIRE).burn_kernel_radius == 1
        assert got["grid"][4, 3] == A_TREE and got["grid"][4, 5] == A_TREE
        assert (got["grid"][5, 3:6] == A_FIRE).all()


def j_advanced_env(env):
    per_env = {k: jnp.asarray(v) for k, v in env["per_env"].items()}
    return jnp.asarray(env["grid"]), per_env, j_shared(ADV_SHARED)[0]


def with_day_length(fn):
    """``fn`` jitted with the shared context's static ``day_length``."""
    return jax.jit(lambda g, pe, sh, *rest: fn(g, pe, {**sh, "day_length": 400}, *rest))


def test_advanced_spatial_matches_jax(world):
    """Two Advanced envs at 32², each stepped alone on 2 bands: grid, fire
    age, dousing, time step, night flag, position, carried key, reward and
    done equal the JAX ``advanced_step_spatial`` bit for bit; the first env
    douses where it stands and its fire spreads."""
    got = rank0(world, 2, "advanced")
    mesh = make_mesh(2)
    step = with_day_length(lambda g, pe, sh, a, k: advanced_step_spatial(
        jca_of(32), g, pe, sh, a, k, mesh))
    for env, rec in zip(ADV_ENVS, got):
        grid, per_env, shared = j_advanced_env(env)
        g, pe, reward, done = step(grid, per_env, shared, jnp.asarray(env["action"]),
                                   wrap(env["key"]))
        np.testing.assert_array_equal(rec["grid"], np.asarray(g))
        for k in ("fire_age", "dousing_count", "time_step", "is_night", "position"):
            np.testing.assert_array_equal(rec[k], np.asarray(pe[k]), err_msg=k)
        np.testing.assert_array_equal(rec["key"], kd(pe["key"]))
        assert rec["reward"] == np.asarray(reward) and rec["done"] == np.asarray(done)
    assert got[0]["dousing_count"][4, 7] == 1 and got[0]["time_step"] == 2
    assert got[0]["reward"] < 0 and not got[0]["done"]


def test_advanced_batched_spatial_matches_per_env_steps(world):
    """The two envs stacked on a (2, 2) mesh equal each env stepped alone on
    2 bands (the same band count, so the same shard-folded draws) and the
    JAX ``advanced_step_batched_spatial`` on a (2, 2) mesh, bit for bit."""
    got = rank0(world, 4, "advanced_batched")
    alone = rank0(world, 2, "advanced")
    for i, rec in enumerate(alone):
        for k in ("grid", "fire_age", "dousing_count", "position", "key", "time_step"):
            np.testing.assert_array_equal(got[k][i], rec[k], err_msg=f"env {i} {k}")
        assert got["reward"][i] == rec["reward"] and got["done"][i] == rec["done"]
    envs = [j_advanced_env(e) for e in ADV_ENVS]
    per_envs = jax.tree.map(lambda *xs: jnp.stack(xs), *[e[1] for e in envs])
    mesh = make_2d_mesh(2, 2)
    step = with_day_length(lambda g, pe, sh, a, k: advanced_step_batched_spatial(
        jca_of(32), g, pe, sh, a, k, mesh))
    g, pe, rew, done = step(jnp.stack([e[0] for e in envs]), per_envs, envs[0][2],
                            jnp.asarray(np.stack([e["action"] for e in ADV_ENVS])),
                            wrap(np.stack([e["key"] for e in ADV_ENVS])))
    np.testing.assert_array_equal(got["grid"], np.asarray(g))
    np.testing.assert_array_equal(got["fire_age"], np.asarray(pe["fire_age"]))
    np.testing.assert_array_equal(got["dousing_count"], np.asarray(pe["dousing_count"]))
    np.testing.assert_array_equal(got["reward"], np.asarray(rew))
    np.testing.assert_array_equal(got["done"], np.asarray(done))


# --- placement -----------------------------------------------------------------------------


def test_shard_env_batch_keeps_each_ranks_block(world):
    """4 Advanced envs over 4 ranks: each rank holds its env of the rgb, the
    keys and every info leaf; a scalar of the shared context stays whole."""
    for res in world(4):
        r = res["env_batch"]
        assert r["rgb_shape"] == (1, 16, 16, 3)
        assert r["rgb"] and r["keys"] and r["scalar_kept"]
        assert all(r["info"].values()), r["info"]
