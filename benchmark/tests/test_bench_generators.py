"""The benchmark's inputs repeat from a seed, and its key chain is the
port's."""

import pytest
import torch

from benchmark.reference import keys as K
from benchmark.terrain import make_terrain
from benchmark.traffic.episodes import Driver, sample_envs
from gymca_torch import rng

SEED = 2**31 + 977  # a run's seed may pass 32 signed bits


def test_terrain_repeats_from_the_seed():
    a, b = make_terrain(3, 24, 20, SEED, "cpu"), make_terrain(3, 24, 20, SEED, "cpu")
    c = make_terrain(3, 24, 20, SEED + 1, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["altitude"], c["altitude"])
    assert a["exp_slope"].shape == (3, 3, 3, 24, 20) and a["exp_slope"].dtype == torch.bfloat16
    assert int(a["vegetation"].min()) >= 1 and int(a["vegetation"].max()) <= 5


class _Recorder:
    """A system that records the actions it is given."""

    def __init__(self):
        self.seen = []

    def restart(self):
        pass

    def state(self):
        return None

    def step(self, actions, span):
        self.seen.append(actions.clone())

    def work_inputs(self):
        return {}


@pytest.mark.parametrize("columns", [[[0, 9], [0, 2]], [[0, 9], [0, 2], [0, 1]]])
def test_actions_repeat_from_the_seed_and_fill_their_ranges(columns):
    traffic = {"envs": 50, "episode_steps": 40, "actions": columns, "trace_steps": 0}
    runs = []
    for seed in (SEED, SEED, SEED + 1):
        system = _Recorder()
        Driver(system, traffic, seed, "cpu", False).window(0, max_steps=90)
        runs.append(torch.stack(system.seen))
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    acts = runs[0]
    assert acts.shape == (90, 50, len(columns)) and acts.dtype == torch.int32
    for c, (lo, hi) in enumerate(columns):
        assert set(acts[..., c].unique().tolist()) == set(range(lo, hi))
    # episodes of 40 steps: each starts with fresh draws
    assert not torch.equal(acts[:40], acts[40:80])


def test_traced_steps_do_not_depend_on_how_far_the_window_got():
    """A traced run profiles steps ``trace_from`` on of an episode drawn from
    the seed alone: the window's first episode's draw."""
    traffic = {"envs": 6, "episode_steps": 20, "actions": [[0, 9], [0, 2]],
               "trace_from": 7, "trace_steps": 4}
    traced = []
    for steps in (13, 58):
        system = _Recorder()
        rec = Driver(system, traffic, SEED, "cpu", True).window(0, max_steps=steps)
        assert len(system.seen) == steps + 7 + 4
        assert torch.equal(torch.stack(system.seen[-4:]), torch.stack(system.seen[7:11]))
        traced.append(torch.stack([a for _, a in rec["traced"]]))
    assert torch.equal(traced[0], traced[1])


def test_sample_repeats_from_the_seed():
    a, b = sample_envs(SEED, 4096, 256), sample_envs(SEED, 4096, 256)
    assert torch.equal(a, b) and len(a.unique()) == 256
    assert not torch.equal(a, sample_envs(SEED + 1, 4096, 256))
    assert torch.equal(sample_envs(SEED, 64, 256), torch.arange(64))


def test_key_chain_equals_the_port():
    key = K.key(SEED, "cpu")
    assert torch.equal(key, rng.key(SEED % 2**32, device="cpu"))
    keys = K.split(key, 7)
    assert torch.equal(keys, rng.split(key, 7))
    assert torch.equal(K.fold_in(keys, 7), rng.fold_in(keys, 7))
    assert torch.equal(K.uniform(keys, (5, 3)), rng.uniform(keys, (5, 3)))
    for lo, hi in ((0, 8), (1, 8), (0, 21), (576, 672)):
        assert torch.equal(K.randint(keys, (4, 6), lo, hi), rng.randint(keys, (4, 6), lo, hi))
    p = (0.1, 0.9, 0.0)
    assert torch.equal(K.choice(keys, (9, 11), p), rng.choice(keys, 3, (9, 11), p))
