"""The program's spans (``gymca_torch.utils.metrics.span``): off by default,
the calls each path counts on a windy and an Advanced step, the key chain's
operations inside ``gymca.rng`` ranges, closing on an exception, and steps
equal bit for bit with spans on and off.  CPU only, small sizes."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from gymca_torch import rng
from gymca_torch.envs import bulldozer
from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv
from gymca_torch.envs.bulldozer import BulldozerCore
from gymca_torch.utils import metrics

N = 4
WINDY_CALLS = {"step_batched": 1, "step_batched/rng": 4, "step_batched/ca": 1}
ADVANCED_CALLS = {
    "stateless_step": 1, "stateless_step/rng": 5, "stateless_step/ca": 1,
    "stateless_step/observe": 1, "conditional_reset": 1, "conditional_reset/rng": 3,
    "conditional_reset/fresh_state": 1, "conditional_reset/fresh_state/rng": 2,
    "conditional_reset/observe": 1,
}
HASH_OPS = ("aten::__and__", "aten::__or__", "aten::__xor__", "aten::__lshift__",
            "aten::__rshift__", "aten::add")


@pytest.fixture(autouse=True)
def spans_off():
    metrics.disable()
    metrics.reset()
    yield
    metrics.disable()
    metrics.reset()


@pytest.fixture(scope="module")
def windy():
    core = BulldozerCore(64, 64, device="cpu")  # one CA update a step at most
    states = core.initial_state(rng.split(rng.key(11, device="cpu"), N))
    g = torch.Generator().manual_seed(12)
    actions = torch.stack([torch.randint(0, 9, (N,), generator=g),
                           torch.randint(0, 2, (N,), generator=g)], -1).int()
    return core, states, actions


@pytest.fixture(scope="module")
def advanced():
    env = AdvancedForestFireBulldozerEnv(32, 32, key=rng.key(5, device="cpu"), num_envs=N,
                                         use_fused_ca=True, device="cpu")
    obs, info = env.reset()
    actions = torch.tensor([[1, 1, 0], [4, 0, 0], [8, 1, 0], [2, 0, 0]], dtype=torch.int32)
    return env, obs, info, actions


def windy_step(windy):
    core, states, actions = windy
    return core.step_batched(states.clone(), actions)


def advanced_step(advanced):
    env, obs, info, actions = advanced
    out = env.stateless_step(actions, obs, info)
    terminated = torch.tensor([True, False, True, False])  # two envs reset
    return env.conditional_reset(out[:2] + (terminated,) + out[3:], actions)


def leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    if hasattr(tree, "__dataclass_fields__"):
        return [x for k in tree.__dataclass_fields__ for x in leaves(getattr(tree, k))]
    return []


def annotations(prof, prefix):
    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.name().startswith(prefix)]


@pytest.mark.parametrize("step", [windy_step, advanced_step], ids=["windy", "advanced"])
def test_spans_are_off_by_default(step, windy, advanced):
    fixture = windy if step is windy_step else advanced
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(fixture)
    assert metrics.snapshot() == {}
    assert annotations(prof, metrics.SPAN_PREFIX) == []


@pytest.mark.parametrize("step,calls", [(windy_step, WINDY_CALLS),
                                        (advanced_step, ADVANCED_CALLS)],
                         ids=["windy", "advanced"])
def test_each_path_counts_its_calls(step, calls, windy, advanced):
    fixture = windy if step is windy_step else advanced
    metrics.enable()
    for _ in range(2):
        step(fixture)
    snap = metrics.snapshot()
    assert {path: c[0] for path, c in snap.items()} == {p: 2 * c for p, c in calls.items()}
    for path, (_, total, child) in snap.items():
        assert 0 <= child <= total, path
        below = [p for p in snap if p.rsplit("/", 1)[0] == path and p != path]
        assert child == sum(snap[p][1] for p in below), path


def test_the_key_chains_hashes_lie_inside_rng_ranges(windy, monkeypatch):
    derive = bulldozer.derive_step_key

    def marked(keys):
        with record_function("test.derive_step_key"):
            return derive(keys)

    monkeypatch.setattr(bulldozer, "derive_step_key", marked)
    metrics.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        windy_step(windy)
    (d0, d1, _), = annotations(prof, "test.")
    ranges = [(s, e) for s, e, n in annotations(prof, metrics.SPAN_PREFIX)
              if n == "gymca.rng"]
    assert len(ranges) == WINDY_CALLS["step_batched/rng"]
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name() in HASH_OPS and d0 <= e.start_ns() <= d1]
    assert len(ops) > 400  # four hashes of ~170 integer operations
    assert all(any(s <= a and b <= e for s, e in ranges) for a, b in ops)


def test_a_span_closes_on_an_exception():
    metrics.enable()

    @metrics.span("outer")
    def outer():
        with metrics.span("inner"):
            with metrics.span("inner"):  # nested in its own name: counts as the outer one
                raise KeyError("x")

    for _ in range(2):
        with pytest.raises(KeyError):
            outer()
    with metrics.span("after"):
        pass
    assert {p: c[0] for p, c in metrics.snapshot().items()} == {
        "outer": 2, "outer/inner": 2, "after": 1}
    assert metrics._stack == []


def test_profile_trace_turns_spans_on_for_its_block(windy, tmp_path):
    with metrics.profile_trace(True, str(tmp_path)):
        windy_step(windy)
    assert not metrics._on
    names = {e.get("name") for e in json.loads((tmp_path / metrics.TRACE_FILE).read_text())
             ["traceEvents"]}
    assert {"gymca.step_batched", "gymca.rng", "gymca.ca"} <= names
    assert {p: c[0] for p, c in metrics.snapshot().items()} == WINDY_CALLS


@pytest.mark.parametrize("step", [windy_step, advanced_step], ids=["windy", "advanced"])
def test_steps_are_equal_with_spans_on_and_off(step, windy, advanced):
    fixture = windy if step is windy_step else advanced
    off = leaves(step(fixture))
    metrics.enable()
    with profile(activities=[ProfilerActivity.CPU]):
        on = leaves(step(fixture))
    assert metrics.snapshot() and len(on) == len(off) > 5
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)
