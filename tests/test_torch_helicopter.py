"""The port's Helicopter against the JAX package's, on the CPU.

``drossel_step`` and ``ForestFire`` on numpy grids with ``jax.random``
keys; ``HelicopterCore`` step by step against ``jax.jit(jax.vmap(...))`` of
the JAX core's ``step`` and ``autoreset_step`` over more than three freeze
cycles; ``ForestFireHelicopterEnv`` episodes against the JAX env; then
``tests/test_envs.py``'s Helicopter contract on the port.  Every comparison
has tolerance 0.  The reward is compared with the jitted JAX step, whose
rounding the port takes (``HelicopterCore._award``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymca_torch.core.env import autoreset_step
from gymca_torch.core.operator import Operator
from gymca_torch.envs.helicopter import HelicopterCore
from gymca_torch.gym_env import ForestFireHelicopterEnv
from gymca_torch.ops.drossel import ForestFire, drossel_step
from gymca_tpu.core.env import autoreset_step as j_autoreset_step
from gymca_tpu.envs.helicopter import ForestFireHelicopterEnv as JEnv
from gymca_tpu.envs.helicopter import HelicopterCore as JCore
from gymca_tpu.ops.drossel import ForestFire as JForestFire
from gymca_tpu.ops.drossel import drossel_step as j_drossel_step

EMPTY, TREE, FIRE = 0, 1, 2
CORE_STEPS = 75  # 42²: the CA every 22 steps (max_freeze 21), so 3 cycles and more


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def key_data(keys):
    return torch.tensor(np.asarray(jax.random.key_data(keys)).astype(np.int64))


def grids(seed, shape):
    return np.random.default_rng(seed).integers(0, 3, shape).astype(np.int32)


# --- the CA ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,dtype", [((8, 42, 42), np.int32), ((3, 17, 23), np.int8)])
def test_drossel_step_matches_jax(shape, dtype):
    """Per-env probabilities (tensors), then scalar ones."""
    g = grids(1, shape).astype(dtype)
    keys = jax.random.split(jax.random.key(shape[1]), shape[0])
    p_fire = np.linspace(0.0, 0.5, shape[0]).astype(np.float32)
    p_tree = np.linspace(0.6, 0.1, shape[0]).astype(np.float32)
    step = jax.jit(jax.vmap(lambda x, pf, pt, k: j_drossel_step(
        x, pf, pt, k, empty=EMPTY, tree=TREE, fire=FIRE)))
    for pf, pt in ((p_fire, p_tree), (0.033, 0.333)):
        want = step(g, np.broadcast_to(np.float32(pf), shape[:1]),
                    np.broadcast_to(np.float32(pt), shape[:1]), keys)
        as_arg = (lambda p: torch.tensor(p)) if isinstance(pf, np.ndarray) else float
        got = drossel_step(torch.tensor(g), as_arg(pf), as_arg(pt), key_data(keys),
                           empty=EMPTY, tree=TREE, fire=FIRE)
        assert got.dtype == torch.from_numpy(g).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(8, 42, 42), (3, 17, 23)])
def test_forest_fire_operator_matches_jax(shape):
    g = grids(2, shape)
    keys = jax.random.split(jax.random.key(7), shape[0])
    ctx = np.stack([np.full(shape[0], 0.033, np.float32),
                    np.full(shape[0], 0.333, np.float32)], axis=-1)
    op = JForestFire(EMPTY, TREE, FIRE)
    want_grid, want_ctx = jax.vmap(lambda x, c, k: op(x, None, c, k))(g, ctx, keys)
    got_grid, got_ctx = ForestFire(EMPTY, TREE, FIRE)(torch.tensor(g), None,
                                                      torch.tensor(ctx), key_data(keys))
    np.testing.assert_array_equal(got_grid.numpy(), np.asarray(want_grid))
    np.testing.assert_array_equal(got_ctx.numpy(), np.asarray(want_ctx))


# --- the core -------------------------------------------------------------------------


def assert_state_equal(got, want, where):
    np.testing.assert_array_equal(got.grid.numpy(), np.asarray(want.grid), err_msg=where)
    assert set(got.context) == set(want.context)
    for k, v in want.context.items():
        np.testing.assert_array_equal(got.context[k].numpy(), np.asarray(v),
                                      err_msg=f"{where} {k}")
        assert got.context[k].numpy().dtype == np.asarray(v).dtype, (where, k)
    np.testing.assert_array_equal(got.key.numpy(),
                                  np.asarray(jax.random.key_data(want.key)), err_msg=where)
    for leaf in ("done", "steps_elapsed", "reward_accumulated"):
        np.testing.assert_array_equal(getattr(got, leaf).numpy(),
                                      np.asarray(getattr(want, leaf)), err_msg=where)


@pytest.mark.parametrize("size,n,kw", [((42, 42), 8, {}),
                                       ((17, 23), 3, {"speed": 0.2, "p_fire": 0.2})])
def test_core_autoreset_matches_jax(size, n, kw):
    """Grid, context, key, reward (float32), done and steps over 75 steps of
    ``autoreset_step``, random actions."""
    jc, pc = JCore(*size, **kw), HelicopterCore(*size, device="cpu", **kw)
    keys = jax.random.split(jax.random.key(11), n)
    js = jax.vmap(jc.initial_state)(keys)
    ps = pc.initial_state(key_data(keys))
    assert_state_equal(ps, js, "initial")
    step = jax.jit(jax.vmap(lambda s, a: j_autoreset_step(jc, s, a)))
    actions = np.random.default_rng(3).integers(0, 9, (CORE_STEPS, n)).astype(np.int32)
    ca_steps = 0
    for t in range(CORE_STEPS):
        ca_steps += int(ps.context["freeze"][0] == 0)
        js, jo = step(js, jnp.asarray(actions[t]))
        ps, po = autoreset_step(pc, ps, torch.tensor(actions[t]))
        assert_state_equal(ps, js, f"step {t}")
        assert po.reward.dtype == torch.float32
        np.testing.assert_array_equal(po.reward.numpy(), np.asarray(jo.reward))
        np.testing.assert_array_equal(po.terminated.numpy(), np.asarray(jo.terminated))
        np.testing.assert_array_equal(po.info["hit"].numpy(), np.asarray(jo.info["hit"]))
        for got, want in zip(po.obs[1], jo.obs[1]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ca_steps >= 3


def test_core_step_matches_jax_vmap_step():
    """``core.step`` against ``jax.jit(jax.vmap(core.step))``, the CA due at
    once (freeze 0) and then frozen."""
    jc, pc = JCore(42, 42, freeze=0), HelicopterCore(42, 42, freeze=0, device="cpu")
    keys = jax.random.split(jax.random.key(5), 4)
    js, ps = jax.vmap(jc.initial_state)(keys), pc.initial_state(key_data(keys))
    step = jax.jit(jax.vmap(jc.step))
    for t, a in enumerate([0, 4, 8, 2, 6]):
        act = np.full(4, a, np.int32)
        js, jo = step(js, jnp.asarray(act))
        ps, po = pc.step(ps, torch.tensor(act))
        assert_state_equal(ps, js, f"step {t}")
        np.testing.assert_array_equal(po.reward.numpy(), np.asarray(jo.reward))


def test_max_freeze_at_the_registered_size():
    core = HelicopterCore(42, 42, device="cpu")
    assert core._max_freeze == JCore(42, 42)._max_freeze == 21
    assert core.freeze_spec.n == 22


# --- the gymnasium env ----------------------------------------------------------------


def host_equal(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            host_equal(g, w)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            host_equal(got[k], want[k])
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_env_episodes_match_jax():
    """``reset(seed)`` then steps, twice (a second seed), against the JAX env:
    observations, rewards, flags and info equal."""
    jenv, penv = JEnv(42, 42, seed=2), ForestFireHelicopterEnv(42, 42, seed=2, device="cpu")
    host_equal(penv.reset()[0], jenv.reset()[0])
    actions = np.random.default_rng(4).integers(0, 9, 30)
    for a in actions:
        host_equal(penv.step(int(a)), jenv.step(int(a)))
    host_equal(penv.reset(seed=9), jenv.reset(seed=9))
    for a in actions[:8]:
        host_equal(penv.step(int(a)), jenv.step(int(a)))
    assert penv.status() == jenv.status()


# --- tests/test_envs.py's Helicopter contract ------------------------------------------


def assert_operator(op):
    assert isinstance(op, Operator)
    assert isinstance(op.suboperators, tuple)
    for attr in ("grid_dependant", "action_dependant", "context_dependant", "deterministic"):
        assert isinstance(getattr(op, attr), bool), f"{op}.{attr} must be set"
    for sub in op.suboperators:
        assert_operator(sub)


def test_mdp_operator_contract():
    assert_operator(HelicopterCore(8, 8, device="cpu").mdp)


def test_never_done_and_reward_range():
    env = ForestFireHelicopterEnv(8, 8, seed=1, device="cpu")
    env.reset()
    for _ in range(6):
        obs, r, term, trunc, info = env.step(env.action_space.sample())
        assert not term
        assert -1.0 <= r <= 1.0
        assert "hit" in info


def test_freeze_gates_ca():
    core = HelicopterCore(8, 8, freeze=3, device="cpu")
    state = core.initial_state(key_data(jax.random.split(jax.random.key(0), 1)))
    assert int(state.context["freeze"][0]) == 3
    state, _ = core.step(state, torch.tensor([4]))
    assert int(state.context["freeze"][0]) == 2


def test_helicopter_extinguishes():
    core = HelicopterCore(4, 4, freeze=100, device="cpu")  # CA frozen: only the agent acts
    state = core.initial_state(key_data(jax.random.split(jax.random.key(0), 1)))
    grid = torch.full((1, 4, 4), TREE, dtype=torch.int32)
    grid[0, 2, 2] = FIRE
    position = torch.tensor([[2, 2]], dtype=torch.int32)
    state = state.replace(grid=grid, context={**state.context, "position": position})
    new_state, out = core.step(state, torch.tensor([4]))  # not_move + autoshoot
    assert int(new_state.grid[0, 2, 2]) == EMPTY
    assert bool(out.info["hit"][0])


def test_prototypes_across_sizes():
    for shape in [(5, 5), (12, 16)]:
        env = ForestFireHelicopterEnv(*shape, seed=0, device="cpu")
        obs, _ = env.reset()
        assert obs[0].shape == shape


def test_core_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HelicopterCore(8, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ForestFireHelicopterEnv(8, 8)
