"""The port's data-parallel PPO (``gymca_torch.parallel.sharded``) against the
JAX package's, on the CPU.

The port's ranks are spawned gloo processes (``tests/torch_parallel_ranks.py``),
one world each of 1, 2 and 4 ranks per module; the JAX ``DataParallelPPO``
runs here on conftest's virtual devices.  Both start from the same env
(the JAX env's terrain and key), the same trainer key and the same weights
(the JAX trainer's, carried by ``interop.ppo_params_from_numpy``), at
``tests/test_parallel_ppo.py``'s size: 4 envs x 16², 8 steps, one epoch of
2 minibatches.  Each test states its tolerance.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from gymca_torch import interop
from gymca_tpu.agents.args import Args, EnvArgs, ExperimentArgs, PPOArgs, VisualizationArgs
from gymca_tpu.envs.advanced import AdvancedForestFireBulldozerEnv as JEnv
from gymca_tpu.parallel.mesh import make_mesh
from gymca_tpu.parallel.sharded import DataParallelPPO as JDP
from torch_parallel_ranks import run_world

N_ENVS, SIZE, STEPS = 4, 16, 8
BF16 = ("exp_slope", "veg_den_factor")
PARAM_ATOL = 2e-6  # tests/test_torch_ppo.py's, after one train_iteration
METRIC_RTOL, METRIC_ATOL = 1e-3, 1e-6  # atol for metrics that are float noise about 0
ITERS = 15  # tests/test_parallel_ppo.py's shard-count run


def args_dict(**exp_kw):
    """``tests/test_parallel_ppo.py``'s ``make_args`` as keyword dicts."""
    return {"ppo": {"num_minibatches": 2, "update_epochs": 1},
            "env": {"num_envs": N_ENVS, "size": SIZE},
            "exp": {"total_timesteps": N_ENVS * STEPS * 4, "num_ppo_steps": STEPS, "seed": 5,
                    **exp_kw}}


def ks_args():
    a = args_dict(critic_warmup_iters=1, centroid_features=True)
    a["ppo"].update(kickstart_coef=1.0, kickstart_decay_iters=2)
    return a


def j_args(a):
    return Args(ppo=PPOArgs(**a["ppo"]), env=EnvArgs(**a["env"]), viz=VisualizationArgs(),
                exp=ExperimentArgs(**a["exp"]))


def torch_key(jkey):
    return torch.tensor(np.asarray(jax.random.key_data(jkey)).astype(np.int64))


JENV = JEnv(SIZE, SIZE, key=jax.random.key(0), num_envs=N_ENVS)
ENV = {"size": SIZE, "num_envs": N_ENVS, "key": torch_key(JENV.starting_key),
       "terrain": {k: (interop._bf16_from_numpy(np.asarray(v), "cpu") if k in BF16
                       else torch.tensor(np.asarray(v)))
                   for k, v in JENV._terrain_ctx.items()}}
KEY = torch_key(jax.random.key(5))


@functools.lru_cache(maxsize=None)
def j_dp(devices):
    return JDP(JENV, j_args(args_dict()), make_mesh(devices), key=jax.random.key(5))


def carried_params(jdp):
    return interop.ppo_params_from_numpy(jax.device_get(dict(jdp.trainer.agent_state.params)),
                                         "cpu")


def cases_for(world):
    base = {"env": ENV, "args": args_dict(), "key": KEY, "devices": world}
    cases = [("iteration", "dp_iteration",
              {**base, "params": carried_params(j_dp(world)), "single": world == 1}),
             ("train", "dp_train", {**base, "iterations": ITERS})]
    if world == 1:
        cases.append(("plain", "dp_plain", base))
    if world == 2:
        cases.append(("kickstart", "dp_kickstart", {**base, "args": ks_args()}))
    return cases


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    runs = {}

    def get(n):
        if n not in runs:
            runs[n] = run_world(n, cases_for(n), tmp_path_factory.mktemp(f"ppo{n}"))
        return runs[n]

    return get


def flat_params(tree):
    return {f"{g}/{k}": np.asarray(v) for g, d in tree.items() for k, v in d.items()}


def test_one_rank_equals_the_port_trainer_bit_for_bit(world):
    """World 1: one ``train_iteration`` of ``DataParallelPPO`` equals
    ``PPOTrainer.train_iteration`` from ``split(key, 1)[0]`` with the same
    weights, every metric and param bit for bit (the mean over one rank is
    the sum times 1.0); one gradient all-reduce a minibatch, one metrics
    all-reduce."""
    r = world(1)[0]["iteration"]
    assert r["metrics_bits"]
    assert r["metrics"] == r["single_metrics"]
    got, want = flat_params(r["params"]), flat_params(r["single_params"])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert r["grad_all_reduces"] == 2 and r["metric_all_reduces"] == 1


@pytest.mark.parametrize("devices", [1, 2])
def test_matches_jax_data_parallel_ppo(world, devices):
    """One iteration on ``devices`` ranks against the JAX ``DataParallelPPO``
    on as many shards, from the same weights and keys: the metrics within
    rtol 1e-3 (atol 1e-6), every param within ``PARAM_ATOL`` = 2e-6, both
    sides' params moved by more than the learning rate, equal on every
    rank."""
    ranks = world(devices)
    jdp = j_dp(devices)
    start = flat_params(carried_params(jdp))
    out = jdp.train_iteration(*jdp.init_carry())
    j_metrics = {k: float(v) for k, v in jax.device_get(out[-1]).items()}
    want = flat_params(interop.ppo_params_from_numpy(jax.device_get(dict(out[0].params)),
                                                     "cpu"))
    r = ranks[0]["iteration"]
    assert sorted(r["metrics"]) == sorted(j_metrics)
    for k, v in j_metrics.items():
        np.testing.assert_allclose(r["metrics"][k], v, rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                   err_msg=k)
    got = flat_params(r["params"])
    gap = max(np.abs(got[k] - want[k]).max() for k in want)
    assert gap <= PARAM_ATOL, gap
    lr = jdp.args.ppo.learning_rate
    assert max(np.abs(want[k] - start[k]).max() for k in want) > lr
    assert max(np.abs(got[k] - start[k]).max() for k in want) > lr
    for other in ranks[1:]:
        assert other["iteration"]["metrics"] == r["metrics"]
        for k, v in flat_params(other["iteration"]["params"]).items():
            np.testing.assert_array_equal(v, got[k], err_msg=k)
    assert r["grad_all_reduces"] == 2 and r["step"] == 2


def test_four_ranks_train_finite(world):
    for rank in world(4):
        for m in rank["train"][:2]:
            assert all(np.isfinite(v) for v in m.values()), m


def test_shard_count_effect_bounded(world):
    """``tests/test_parallel_ppo.py``'s bands: 15 iterations at 1, 2 and 4
    ranks from the same seed, losses finite, and the last 5 iterations'
    mean loss and mean reward within the same two-sided bands of the
    1-rank run."""
    results = {}
    for n in (1, 2, 4):
        hist = world(n)[0]["train"]
        assert len(hist) == ITERS and all(np.isfinite(m["loss"]) for m in hist), n
        results[n] = {k: np.mean([m[k] for m in hist[-5:]]) for k in ("loss", "mean_reward")}
    base = results[1]
    for n in (2, 4):
        r = results[n]
        assert abs(r["loss"] - base["loss"]) <= max(0.5, 2.0 * abs(base["loss"])), results
        assert abs(r["mean_reward"] - base["mean_reward"]) < 0.25, results


def test_critic_warmup_and_kickstart_on_two_ranks(world):
    """A critic-warmup iteration leaves torso and actor bit-identical and
    moves the critic; the annealed kickstart iteration after it is finite."""
    for rank in world(2):
        r = rank["kickstart"]
        assert r["network"] and r["actor"] and not r["critic"]
        assert all(np.isfinite(v) for v in r["metrics"].values()), r["metrics"]


def test_plain_args_build_no_kickstart_callables(world):
    r = world(1)[0]["plain"]
    assert r["ks"] and r["warmup"]
