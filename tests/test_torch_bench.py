"""``python3 -m gymca_torch.bench`` against ``bench.py``'s loops.

The JAX side is bench.py's loop bodies, copied here with their line
numbers and made to return their end states (bench.py itself is read, not
edited or imported).  On the windy side ``jax.vmap(core.step)`` stands in
for the fused step, which equals it bit for bit (``tests/test_pallas.py``);
the port's ``step_batched`` goes through K1's wrapper, which takes its plain
version on these CPU tensors.  The JAX loops are jitted once per module.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gymca_torch.envs.bulldozer as tbulldozer
from gymca_torch import bench, rng
from gymca_tpu.envs.advanced import AdvancedForestFireBulldozerEnv as JEnv
from gymca_tpu.envs.bulldozer import BulldozerCore as JCore
from test_torch_advanced import assert_same
from test_torch_bulldozer import assert_states_equal

WINDY_SIZE, WINDY_ENVS, WINDY_STEPS = 48, 6, 8  # 48²: one CA period a step at most
ADV_SIZE, ADV_ENVS, ADV_STEPS = 64, 4, 6
# Per-step reward sums: float32 sums over the envs in another order than
# XLA's, of rewards in [-1, 0]: a few ulps of the sum's magnitude at most.
REWARD_RTOL, REWARD_ATOL = 1e-6, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_windy():
    """bench.py:44-52 and :99-116 with ``step = jax.vmap(core.step)``:
    the reset states and the jitted run, which returns the end states."""
    num_envs, steps = WINDY_ENVS, WINDY_STEPS
    core = JCore(WINDY_SIZE, WINDY_SIZE)
    key = jax.random.key(0)
    keys = jax.random.split(key, num_envs)
    states = jax.vmap(core.initial_state)(keys)
    step = jax.vmap(core.step)

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

    return states, run, key


@pytest.fixture(scope="module")
def jax_advanced():
    """bench.py:158-177 on the XLA CA path (``use_pallas_ca=False``, as
    ``--smoke``): the reset and the jitted run, which returns the end
    observation and info beside the reward sums."""
    num_envs, steps = ADV_ENVS, ADV_STEPS
    env = JEnv(ADV_SIZE, ADV_SIZE, key=jax.random.key(0), num_envs=num_envs,
               use_pallas_ca=False)
    obs, info = env.reset()

    @jax.jit
    def run(obs, info, key):
        def body(carry, k):
            obs, info = carry
            acts = jnp.stack(
                [jax.random.randint(k, (num_envs,), 0, 9),
                 jax.random.randint(jax.random.fold_in(k, 1), (num_envs,), 0, 2),
                 jnp.zeros((num_envs,), jnp.int32)], axis=1)
            step_tuple = env.stateless_step(acts, obs, info)
            obs2, _, _, _, info2 = env.conditional_reset(step_tuple, acts)
            return (obs2, info2), step_tuple[1].sum()

        (obs, info), r = jax.lax.scan(
            body, (obs, info), jax.random.split(key, steps))
        return obs, info, r

    return obs, info, run


def test_windy_actions_are_bench_pys():
    """bench.py:100-104 over 3 steps of 5 envs from ``key(7)``."""
    key, want = jax.random.key(7), []
    for _ in range(3):
        key, k_act = jax.random.split(key)
        a = jax.random.randint(k_act, (5, 2), 0, 2, dtype=jnp.int32)
        want.append(a.at[:, 0].set(jax.random.randint(jax.random.fold_in(k_act, 1), (5,), 0, 9)))
    got = bench.windy_actions(rng.key(7, device="cpu"), 3, 5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


def test_windy_bench_equals_bench_pys_loop(jax_windy, monkeypatch):
    """Every run through K1's wrapper (its plain version here); the last
    run, from ``fold_in(key, 4)``, ends in the JAX loop's states, every leaf
    bit for bit after ``materialize_grid``, each step's reward sum within
    ``REWARD_RTOL``."""
    calls = []
    real = tbulldozer.windy_fused_step

    def counted(*args, **kw):
        calls.append(args[0].device)
        return real(*args, **kw)

    monkeypatch.setattr(tbulldozer, "windy_fused_step", counted)
    out = bench.measure_windy(WINDY_SIZE, WINDY_ENVS, WINDY_STEPS, "cpu")
    runs = bench.WARM + bench.REPS
    assert len(out["runs"]) == runs
    assert len(calls) == runs * WINDY_STEPS and {d.type for d in calls} == {"cpu"}
    assert out["path"] == "K1's plain version"

    j_states, run, key = jax_windy
    j_end, j_rewards = run(j_states, jax.random.fold_in(key, 2 + bench.REPS - 1))
    last = out["runs"][-1]
    core = tbulldozer.BulldozerCore(WINDY_SIZE, WINDY_SIZE, device="cpu")
    assert_states_equal(last["states"], j_end, grid=core.materialize_grid(last["states"]),
                        msg="last windy run")
    np.testing.assert_allclose(last["reward_sums"].numpy(), np.asarray(j_rewards),
                               rtol=REWARD_RTOL, atol=REWARD_ATOL)
    assert out["done_fraction"] == float(np.asarray(j_end.done).mean())
    assert out["value"] > 0 and all(r["seconds"] > 0 for r in out["runs"])


def test_advanced_bench_equals_bench_pys_loop(jax_advanced):
    """The XLA CA path at 4 envs x 64²: the last run, from ``key(5)``,
    ends in the JAX loop's observation and info, every leaf bit for bit,
    each step's reward sum within ``REWARD_RTOL``."""
    out = bench.measure_advanced(ADV_SIZE, ADV_ENVS, ADV_STEPS, "cpu", smoke=True)
    assert out["path"] == "XLA-path counterpart"
    assert len(out["runs"]) == bench.WARM + bench.REPS

    obs, info, run = jax_advanced
    j_obs, j_info, j_rewards = run(obs, info, jax.random.key(2 + bench.REPS))
    last = out["runs"][-1]
    assert_same("last Advanced run", (last["obs"], last["info"]), (j_obs, j_info))
    np.testing.assert_allclose(last["reward_sums"].numpy(), np.asarray(j_rewards),
                               rtol=REWARD_RTOL, atol=REWARD_ATOL)


def test_smoke_prints_bench_pys_two_lines(capsys, monkeypatch):
    """``main(["--smoke", "--device-cpu"])``: on stdout the Advanced line,
    then the headline, with bench.py's fields; no Advanced baseline unless
    one is given."""
    monkeypatch.setenv("GYMCA_BENCH_BASELINE_SPS", "1000")
    monkeypatch.delenv("GYMCA_BENCH_ADV_BASELINE_SPS", raising=False)
    lines = bench.main(["--smoke", "--device-cpu"])
    captured = capsys.readouterr()
    printed = [ln for ln in captured.out.splitlines() if ln.strip()]
    assert [json.loads(ln) for ln in printed] == lines
    assert [ln["metric"] for ln in lines] == ["advanced64_env_steps_per_sec",
                                              "bulldozer64_env_steps_per_sec"]
    for ln in lines:
        assert list(ln) == ["metric", "value", "unit", "vs_baseline"]
        assert ln["unit"] == "env-steps/s" and ln["value"] > 0
    assert lines[0]["vs_baseline"] is None
    assert lines[1]["vs_baseline"] == round(lines[1]["value"] / 1000, 2)
    assert "device=cpu" in captured.err and "done fraction" in captured.err
    assert captured.err.count("rep ") == 2 * bench.REPS


def test_advanced_baseline_is_taken_from_the_environment(capsys, monkeypatch):
    monkeypatch.setenv("GYMCA_BENCH_BASELINE_SPS", "1000")
    monkeypatch.setenv("GYMCA_BENCH_ADV_BASELINE_SPS", "10")
    monkeypatch.setenv("GYMCA_BENCH_STEPS", "2")
    monkeypatch.setenv("GYMCA_BENCH_ENVS", "2")
    adv, windy = bench.main(["--smoke", "--device-cpu"])
    assert adv["vs_baseline"] == round(adv["value"] / 10, 2)
    monkeypatch.setenv("GYMCA_BENCH_ADV", "0")
    assert [ln["metric"] for ln in bench.main(["--smoke", "--device-cpu"])] == [
        "bulldozer64_env_steps_per_sec"]


@pytest.mark.parametrize("stencil", ["swar", "boolean"])
def test_a_stencil_other_than_auto_raises(stencil, monkeypatch):
    monkeypatch.setenv("GYMCA_BENCH_STENCIL", stencil)
    with pytest.raises(ValueError, match="exp_ca_variants"):
        bench.main(["--smoke", "--device-cpu"])


def test_without_a_card_the_bench_raises_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["--smoke"])
