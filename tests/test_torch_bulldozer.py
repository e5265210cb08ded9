"""The port's Bulldozer env against the JAX package's, bit for bit (tolerance 0).

Mirrors the parity suite of ``tests/test_pallas.py``: the JAX side steps
with the jitted ``jax.vmap(core.step)``; the port steps the same state
(carried across with ``gymca_torch.interop``) with its eager batched
``step`` and with ``step_batched``, which on the CPU takes K1's plain
version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymca_torch import rng
from gymca_torch.core.env import autoreset_step as t_autoreset_step
from gymca_torch.envs.bulldozer import BulldozerCore as TCore
from gymca_torch.envs.bulldozer import default_grid_dtype
from gymca_torch.interop import env_state_from_numpy, env_state_to_numpy
from gymca_torch.ops.move_modify import Move
from gymca_tpu.core.env import autoreset_step as j_autoreset_step
from gymca_tpu.envs.bulldozer import BulldozerCore as JCore

H, W = 16, 128  # the sizes tests/test_pallas.py uses


def key_data(seed, n):
    kd = np.random.default_rng(seed).integers(0, 2**32, (n, 2), dtype=np.uint64)
    return kd.astype(np.uint32)


def jax_state_numpy(states):
    return {
        "grid": np.asarray(states.grid),
        "context": {k: np.asarray(v) for k, v in states.context.items()},
        "key": np.asarray(jax.random.key_data(states.key)),
        "done": np.asarray(states.done),
        "steps_elapsed": np.asarray(states.steps_elapsed),
        "reward_accumulated": np.asarray(states.reward_accumulated),
    }


def to_port(jstates, device="cpu"):
    return env_state_from_numpy(**jax_state_numpy(jstates), device=device)


def to_jax(leaves, jstates_like):
    ctx = {k: jnp.asarray(v) for k, v in leaves["context"].items()}
    return jstates_like.replace(
        grid=jnp.asarray(leaves["grid"]), context=ctx,
        key=jax.random.wrap_key_data(jnp.asarray(leaves["key"])),
        done=jnp.asarray(leaves["done"]),
        steps_elapsed=jnp.asarray(leaves["steps_elapsed"]),
        reward_accumulated=jnp.asarray(leaves["reward_accumulated"]),
    )


def assert_states_equal(tstates, jstates, grid=None, msg=""):
    """Every leaf equal; ``grid`` replaces the port's grid (materialized)."""
    got = env_state_to_numpy(tstates)
    if grid is not None:
        got["grid"] = grid.numpy()
    want = jax_state_numpy(jstates)
    np.testing.assert_array_equal(got["grid"], want["grid"], err_msg=f"{msg} grid")
    for k in ("key", "done", "steps_elapsed", "reward_accumulated"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{msg} {k}")
    for k, v in want["context"].items():
        if k in ("edit_log", "edit_count") and grid is not None:
            continue  # the fused path's log; the eager path keeps it empty
        np.testing.assert_array_equal(got["context"][k], v, err_msg=f"{msg} {k}")


def assert_outputs_equal(tout, jout, msg=""):
    np.testing.assert_array_equal(tout.reward.numpy(), np.asarray(jout.reward), err_msg=msg)
    np.testing.assert_array_equal(tout.terminated.numpy(), np.asarray(jout.terminated),
                                  err_msg=msg)
    np.testing.assert_array_equal(tout.info["hit"].numpy(), np.asarray(jout.info["hit"]),
                                  err_msg=msg)


def random_actions(rng, n):
    return np.stack([rng.integers(0, 9, n), rng.integers(0, 2, n)], -1).astype(np.int32)


@pytest.mark.parametrize("h,w", [(256, 256), (16, 128), (32, 128), (8, 8), (40, 128),
                                 (24, 256), (2048, 1024)])
def test_default_grid_dtype_matches_jax(h, w):
    assert str(default_grid_dtype(h, w)).split(".")[-1] == str(JCore(h, w)._grid_dtype)


@pytest.mark.parametrize("h,w,kw", [
    (16, 128, {}), (32, 128, {}), (8, 8, {}),
    (16, 128, dict(pos_fire=(3, 5), pos_bull=(10, 100), p_tree=0.7, p_empty=0.3)),
])
def test_initial_state_matches_jax(h, w, kw):
    jc, tc = JCore(h, w, **kw), TCore(h, w, device="cpu", **kw)
    assert tc._edit_log_k == jc._edit_log_k
    assert tc.repeater.max_repeats == jc.repeater.max_repeats
    kd = key_data(h * w, 5)
    jstates = jax.vmap(jc.initial_state)(jax.random.wrap_key_data(jnp.asarray(kd)))
    tstates = tc.initial_state(torch.as_tensor(kd.astype(np.int64)))
    assert tstates.grid.dtype == getattr(torch, str(jc._grid_dtype))
    assert_states_equal(tstates, jstates)


def run_parity(jc, tc, n, steps, seed):
    kd = key_data(seed, n)
    jstates = jax.vmap(jc.initial_state)(jax.random.wrap_key_data(jnp.asarray(kd)))
    eager, fused = to_port(jstates), to_port(jstates)
    step_j = jax.jit(jax.vmap(jc.step))
    r = np.random.default_rng(seed + 1)
    for i in range(steps):
        a = random_actions(r, n)
        jstates, jout = step_j(jstates, jnp.asarray(a))
        eager, eout = tc.step(eager, torch.as_tensor(a))
        fused, fout = tc.step_batched(fused, torch.as_tensor(a))
        assert_states_equal(eager, jstates, msg=f"eager step {i}")
        assert_states_equal(fused, jstates, grid=tc.materialize_grid(fused),
                            msg=f"fused step {i}")
        assert_outputs_equal(eout, jout, f"eager step {i}")
        assert_outputs_equal(fout, jout, f"fused step {i}")
    return jstates, fused


def test_step_batched_parity_with_vmap_step():
    jc, tc = JCore(H, W, grid_dtype=jnp.int32), TCore(H, W, grid_dtype=torch.int32,
                                                       device="cpu")
    assert tc.supports_fused_step()
    run_parity(jc, tc, 3, 12, seed=42)


def test_int8_step_batched_parity():
    jc, tc = JCore(32, 128), TCore(32, 128, device="cpu")
    assert tc._grid_dtype == torch.int8
    run_parity(jc, tc, 2, 4, seed=7)


def test_grid_spanning_several_ca_periods_takes_the_eager_step():
    jc, tc = JCore(8, 8), TCore(8, 8, device="cpu")
    assert tc.repeater.max_repeats > 1 and not tc.supports_fused_step()
    run_parity(jc, tc, 3, 8, seed=3)


def test_deferred_edit_log():
    """Between CA applications shots land in ``edit_log`` (the grid stays
    stale until materialized); a repeat shot at a pending cell does not hit
    again; the log flushes into the grid at the env's next CA application."""
    tc = TCore(H, W, grid_dtype=torch.int32, device="cpu")
    assert tc._edit_log_k >= 1
    states = tc.initial_state(torch.as_tensor(key_data(11, 1).astype(np.int64)))
    r, c = states.context["position"][0].tolist()
    states.grid[0, r, c] = 3
    states.context["tree_count"] = (states.grid == 3).sum(dim=(1, 2)).to(torch.int32)
    shoot_in_place = torch.tensor([[4, 1]], dtype=torch.int32)  # not_move + shoot

    states1, out1 = tc.step_batched(states.clone(), shoot_in_place)
    assert not bool(states1.done[0])
    assert int(states1.context["edit_count"][0]) == 1, "first step crossed a CA period"
    assert bool(out1.info["hit"][0])
    assert int(states1.grid[0, r, c]) == 3  # stale grid ...
    assert int(tc.materialize_grid(states1)[0, r, c]) == 0  # ... materialized write
    tree_count_1 = int(states1.context["tree_count"][0])

    states2, out2 = tc.step_batched(states1, shoot_in_place)
    assert not bool(out2.info["hit"][0])
    assert int(states2.context["tree_count"][0]) == tree_count_1

    for _ in range(8):
        cnt_before = int(states2.context["edit_count"][0])
        states2, _ = tc.step_batched(states2, shoot_in_place)
        if int(states2.context["edit_count"][0]) < cnt_before:
            break
    else:
        pytest.fail("CA never fired within 8 shoot steps")
    assert int(states2.grid[0, r, c]) == 0  # flushed into the grid


def test_edit_log_overflow_matches_vmap_step():
    """Timings that make the 64-entry log cap bind (as in
    ``tests/test_pallas.py``): a move-right+shoot policy over an all-tree row
    logs hits at steps 1..64, overflows into the kernel's modify-only class
    at 65..68, and flushes the full log at the step-69 CA application.  72
    steps against the jitted JAX ``vmap(step)``."""
    kw = dict(t_move=0.0094, t_shoot=0.005, t_any=0.0001, pos_bull=(8, 4),
              pos_fire=(15, 120))
    jc = JCore(H, W, grid_dtype=jnp.int32, **kw)
    tc = TCore(H, W, grid_dtype=torch.int32, device="cpu", **kw)
    assert tc._edit_log_k == 64 and tc.supports_fused_step()

    jstates = jax.vmap(jc.initial_state)(jax.random.wrap_key_data(
        jnp.asarray(key_data(5, 1))))
    grid = jnp.full_like(jstates.grid, 3).at[0, 15, 120].set(25)
    jstates = jstates.replace(grid=grid, context={
        **jstates.context,
        "tree_count": jnp.sum(grid == 3, axis=(1, 2)).astype(jnp.int32),
        "fire_count": jnp.sum(grid == 25, axis=(1, 2)).astype(jnp.int32),
    })
    states = to_port(jstates)
    act = np.asarray([[5, 1]], np.int32)
    step_j = jax.jit(jax.vmap(jc.step))

    saw_overflow = saw_flush = False
    for step in range(1, 73):
        cnt_before = int(states.context["edit_count"][0])
        states, out = tc.step_batched(states, torch.as_tensor(act))
        jstates, jout = step_j(jstates, jnp.asarray(act))
        cnt = int(states.context["edit_count"][0])
        assert_states_equal(states, jstates, grid=tc.materialize_grid(states),
                            msg=f"step {step}")
        assert_outputs_equal(out, jout, f"step {step}")
        if cnt == 64 and cnt_before == 64 and bool(out.info["hit"][0]):
            saw_overflow = True  # the kernel wrote this hit at once
            r, c = states.context["position"][0].tolist()
            assert int(states.grid[0, r, c]) == 0, step
        if cnt < cnt_before:
            saw_flush = True
            assert cnt == 0, step
    assert saw_overflow and saw_flush
    assert not bool(states.done[0])


def test_step_batched_done_freeze():
    """Finished envs: grid, context (stale hit included) and counters frozen,
    reward 0; the same states through the JAX ``vmap(step)`` agree."""
    jc = JCore(H, W, grid_dtype=jnp.int32)
    tc = TCore(H, W, grid_dtype=torch.int32, device="cpu")
    jstates = jax.vmap(jc.initial_state)(jax.random.wrap_key_data(
        jnp.asarray(key_data(12, 2))))
    jstates = jstates.replace(
        done=jnp.asarray([True, False]),
        context={**jstates.context, "hit": jnp.asarray([True, False]),
                 "time": jnp.asarray([0.95, 0.95], jnp.float32)})
    states = to_port(jstates)
    before = states.clone()
    actions = np.asarray([[5, 1], [5, 1]], np.int32)
    new, out = tc.step_batched(states, torch.as_tensor(actions))
    jnew, jout = jax.jit(jax.vmap(jc.step))(jstates, jnp.asarray(actions))
    assert_states_equal(new, jnew, grid=tc.materialize_grid(new))
    assert_outputs_equal(out, jout)

    assert torch.equal(new.grid[0], before.grid[0])
    assert float(out.reward[0]) == 0.0 and bool(out.terminated[0])
    assert int(new.steps_elapsed[0]) == int(before.steps_elapsed[0])
    for k, v in before.context.items():
        assert torch.equal(new.context[k][0], v[0]), k
    assert bool(out.info["hit"][0])
    assert float(new.context["time"][1]) != 0.95  # the live env moved on


def test_step_batched_updates_the_grid_in_place():
    tc = TCore(H, W, grid_dtype=torch.int32, device="cpu")
    states = tc.initial_state(torch.as_tensor(key_data(13, 2).astype(np.int64)))
    grid = states.grid
    new, _ = tc.step_batched(states, torch.tensor([[4, 0], [4, 0]], dtype=torch.int32))
    assert new.grid is grid


def test_autoreset_step_matches_jax():
    h, w, n = 12, 12, 4
    jc, tc = JCore(h, w), TCore(h, w, device="cpu")
    jstates = jax.vmap(jc.initial_state)(jax.random.wrap_key_data(
        jnp.asarray(key_data(14, n))))
    done = np.asarray([True, False, True, False])
    jstates = jstates.replace(done=jnp.asarray(done))
    tstates = to_port(jstates)
    a = random_actions(np.random.default_rng(15), n)
    jnew, jout = jax.jit(jax.vmap(lambda s, x: j_autoreset_step(jc, s, x)))(
        jstates, jnp.asarray(a))
    tnew, tout = t_autoreset_step(tc, tstates, torch.as_tensor(a))
    assert_states_equal(tnew, jnew)
    assert_outputs_equal(tout, jout)


def test_interop_round_trip():
    jc = JCore(H, W)
    jstates = jax.vmap(jc.initial_state)(jax.random.wrap_key_data(
        jnp.asarray(key_data(16, 3))))
    leaves = jax_state_numpy(jstates)
    back = env_state_to_numpy(env_state_from_numpy(**leaves, device="cpu"))
    assert back["key"].dtype == np.uint32
    for k in ("grid", "key", "done", "steps_elapsed", "reward_accumulated"):
        np.testing.assert_array_equal(back[k], leaves[k])
        assert back[k].dtype == leaves[k].dtype
    for k, v in leaves["context"].items():
        np.testing.assert_array_equal(back["context"][k], v)
        assert back["context"][k].dtype == v.dtype
    again = to_jax(back, jstates)
    assert bool(jnp.all(again.grid == jstates.grid))
    with pytest.raises(ValueError):
        env_state_from_numpy(**{**leaves, "key": leaves["key"].astype(np.int64)},
                             device="cpu")


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TCore(H, W)
    with pytest.raises(RuntimeError):
        rng.key(0)
    with pytest.raises(RuntimeError):
        Move()
    leaves = env_state_to_numpy(TCore(H, W, device="cpu").initial_state(
        torch.as_tensor(key_data(17, 1).astype(np.int64))))
    with pytest.raises(RuntimeError):
        env_state_from_numpy(**leaves)


def test_gym_env_episode_matches_jax():
    from gymca_torch.envs.bulldozer import ForestFireBulldozerEnv as TEnv
    from gymca_tpu.envs.bulldozer import ForestFireBulldozerEnv as JEnv

    tenv, jenv = TEnv(12, 12, seed=3, device="cpu"), JEnv(12, 12, seed=3)
    tobs, _ = tenv.reset()
    jobs, _ = jenv.reset()
    np.testing.assert_array_equal(tobs[0], jobs[0])
    assert tenv.action_space == jenv.action_space
    r = np.random.default_rng(18)
    for i in range(40):
        a = r.integers(0, [9, 2])
        tobs, trew, tdone, _, tinfo = tenv.step(a)
        jobs, jrew, jdone, _, jinfo = jenv.step(a)
        np.testing.assert_array_equal(tobs[0], jobs[0], err_msg=f"step {i}")
        assert (trew, tdone, bool(tinfo["hit"])) == (jrew, jdone, bool(jinfo["hit"]))
        assert tenv.observation_space.contains(tobs)
        if tdone:
            break
    assert tenv.count_cells() == jenv.count_cells()
    assert tenv.status() == jenv.status()


def test_gym_env_graceful_after_done():
    from gymca_torch.envs.bulldozer import ForestFireBulldozerEnv as TEnv

    env = TEnv(8, 8, seed=0, device="cpu")
    env.reset()
    env._state.done[:] = True
    env.done = True
    _, reward, done, truncated, _ = env.step(env.action_space.sample())
    assert (reward, done, truncated) == (0.0, True, False)
    assert env.steps_beyond_done == 1
