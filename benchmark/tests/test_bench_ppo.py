"""The trainer cell on the CPU: a toy run of it end to end, the faults its
check must catch, the control, and the traced iteration's busy time by
root span from synthetic kineto events."""

import pytest
import torch

from benchmark import run as bench_run
from benchmark.ppo_trace import IterationTrace, outermost
from benchmark.reference import ppo as P
from benchmark.spans import OUTSIDE
from benchmark.tests import toy_ppo
from benchmark.tests.test_bench_spans import ann, kernel, launch

SEED = 2**31 + 4099


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return bench_run.Spec(toy_ppo.build(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("trace", [False, True])
def test_the_program_passes_its_check(spec, trace):
    r = bench_run.run_cell(spec, "ppo-toy", SEED, 0, trace, "cpu", max_steps=3)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 3 * 2 * 8
    assert r["checks"]["rerun_values_wrong"]["value"] == 0
    assert r["checks"]["env_values_wrong"]["value"] == 0
    assert r["checks"]["chain_values_wrong"]["value"] == 0
    assert r["checks"]["minibatch_values_wrong"]["value"] == 0
    if trace:  # the counters and the spans read on the CPU too
        assert {"mfu.ppo", "samples_per_s.ppo", "policy_host_ms.ppo"} <= set(r["metrics"])


def _loss_fault(trainer_cls):
    real = trainer_cls._ppo_loss

    def loss(self, *args, **kw):  # the entropy bonus left out
        value, aux = real(self, *args, **kw)
        return value + self.args.ppo.ent_coef * aux[2], aux

    return trainer_cls, "_ppo_loss", loss


def _env_fault(env_cls):
    real = env_cls.stateless_step

    def step(self, action, obs, info):
        out = real(self, action, obs, info)
        (rgb, context), *rest = out
        rgb = rgb.clone()
        rgb[-1, 0, 0, 0] ^= 1
        return ((rgb, context), *rest)

    return env_cls, "stateless_step", step


def _adam_fault(optim):
    real = optim.adam_update

    def update(grads, state, params, lr, eps, **kw):
        return real(grads, state, params, lr, eps * 10, **kw)

    return optim, "adam_update", update


def _gae_fault(ppo):
    real = ppo.gae

    def gae(rewards, values, dones, next_value, next_done, gamma, lam):  # gamma for lambda
        return real(rewards, values, dones, next_value, next_done, gamma, gamma)

    return ppo, "gae", gae


def _dropped_fault(trainer_cls):
    real = trainer_cls._update_ppo

    def update(self, *args, **kw):  # each step's result dropped: the params never move
        own = self.__dict__.get("apply_gradients")  # the check's recorder, if any
        apply = self.apply_gradients
        self.apply_gradients = lambda state, grads: (apply(state, grads), state)[1]
        try:
            return real(self, *args, **kw)
        finally:
            if own is None:
                del self.apply_gradients
            else:
                self.apply_gradients = own

    return trainer_cls, "_update_ppo", update


def _repeat_fault(ppo):
    real, first = ppo.value_and_grad, []

    def value_and_grad(fn, params, *args):  # every minibatch the first one's rows
        first[:] = first or [args]
        return real(fn, params, *first[0])

    return ppo, "value_and_grad", value_and_grad


def _partial_fault(rng):
    real = rng.permutation

    def permutation(keys, n):  # half of the samples, each twice
        return real(keys, n)[:n // 2].repeat(2)

    return rng, "permutation", permutation


def _swap_fault(ppo):
    real = ppo.value_and_grad

    def value_and_grad(fn, params, x, a, logp, adv, ret, *rest):  # returns for advantages
        return real(fn, params, x, a, logp, ret[:, None].expand_as(adv), ret, *rest)

    return ppo, "value_and_grad", value_and_grad


@pytest.mark.parametrize("fault,number", [("loss", "loss_gap.loss"),
                                          ("env", "env_values_wrong"),
                                          ("adam", "adam_rel_err"),
                                          ("gae", "advantage_rel_gap"),
                                          ("dropped", "chain_values_wrong"),
                                          ("repeat", "minibatch_values_wrong"),
                                          ("partial", "minibatch_values_wrong"),
                                          ("swap", "minibatch_values_wrong")])
def test_a_broken_iteration_reads_not_correct(spec, monkeypatch, fault, number):
    from gymca_torch import rng
    from gymca_torch.agents import optim
    from gymca_torch.agents import ppo
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv

    make = {"loss": lambda: _loss_fault(ppo.PPOTrainer),
            "env": lambda: _env_fault(AdvancedForestFireBulldozerEnv),
            "adam": lambda: _adam_fault(optim), "gae": lambda: _gae_fault(ppo),
            "dropped": lambda: _dropped_fault(ppo.PPOTrainer),
            "repeat": lambda: _repeat_fault(ppo), "partial": lambda: _partial_fault(rng),
            "swap": lambda: _swap_fault(ppo)}[fault]
    monkeypatch.setattr(*make())
    r = bench_run.run_cell(spec, "ppo-toy", SEED, 0, False, "cpu", max_steps=2)
    assert not r["correct"]
    assert r["checks"][number]["value"] > r["checks"][number]["limit"], r["checks"]


def test_a_rerun_that_differs_reads_not_correct(spec, monkeypatch):
    """The check's re-run must give the window's bits: a trainer whose
    iterations are not a function of their carry fails."""
    from gymca_torch.agents import ppo

    real, calls = ppo.PPOTrainer.rollout, []

    def rollout(self, *args):
        calls.append(1)
        carry, storage = real(self, *args)
        if len(calls) == 4:  # the re-run, after the warm iteration and the window's two
            storage = storage.replace(rewards=storage.rewards + 1e-3)
        return carry, storage

    monkeypatch.setattr(ppo.PPOTrainer, "rollout", rollout)
    r = bench_run.run_cell(spec, "ppo-toy", SEED, 0, False, "cpu", max_steps=2)
    assert r["checks"]["rerun_values_wrong"]["value"] > 0 and not r["correct"]


def test_the_control_fails_the_check():
    from benchmark.terrain import make_terrain

    cfg = toy_ppo.config()
    terrain = make_terrain(2, 32, 32, SEED, "cpu")
    numbers = P.check(cfg, P.control_record(cfg, SEED, 2, terrain, "cpu"), terrain, "cpu")
    assert any(v > P.LIMITS[k] for k, v in numbers.items()), numbers


# One iteration: rollout (a policy kernel, an env kernel), gae, update (a
# kernel in loss_grad, one in optimizer, overlapping), then a fetch outside.
PROGRAM = [ann("gymca.rollout", 0, 100, 1), ann("gymca.policy", 10, 40, 2),
           ann("gymca.stateless_step", 50, 90, 3), ann("gymca.gae", 100, 150, 4),
           ann("gymca.update", 200, 400, 5), ann("gymca.loss_grad", 210, 300, 6),
           ann("gymca.optimizer", 300, 390, 7)]
HOST = [launch(20, 901), launch(60, 902), launch(120, 903), launch(220, 904), launch(310, 905),
        launch(450, 906)]
DEVICE = [kernel("conv", 30, 45, 901, 0), kernel("ca", 70, 80, 902, 0),
          kernel("value", 130, 140, 903, 0), kernel("conv_bwd", 230, 330, 904, 0),
          kernel("adam", 320, 360, 905, 0), kernel("fetch", 460, 470, 906, 0)]


def test_busy_time_counts_under_the_outermost_span_of_each_launch():
    t = IterationTrace(PROGRAM + HOST + DEVICE, 1e-6)
    assert t.root_busy_s == pytest.approx({"rollout": 25e-9, "gae": 10e-9, "update": 130e-9})
    assert t.span_kernels == {"policy": 1, "stateless_step": 1, "gae": 1, "loss_grad": 1,
                              "optimizer": 1, OUTSIDE: 1}
    assert outermost([(0, 10, "a"), (2, 5, "b"), (10, 20, "c")]) == [(0, 10, "a"),
                                                                   (10, 20, "c")]
