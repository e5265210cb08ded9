"""The PPO trainer's spans and counters (``gymca_torch.utils.metrics.span``):
the calls an iteration counts under each path, the env's spans under the
rollout, the work counters, and an iteration equal bit for bit with spans
on and off.  CPU only: 2 envs on a 32² grid, 8 rollout steps, 2 minibatches,
2 epochs."""

import pytest
import torch

from gymca_torch import rng
from gymca_torch.agents.args import Args, EnvArgs, ExperimentArgs, PPOArgs
from gymca_torch.agents import ppo
from gymca_torch.agents.ppo import EpisodeStatistics, PPOTrainer
from gymca_torch.envs.advanced import TERRAIN_KEYS, AdvancedForestFireBulldozerEnv
from gymca_torch.utils import metrics

N, SIZE, STEPS, MINIBATCHES, EPOCHS = 2, 32, 8, 2, 2
UPDATES = MINIBATCHES * EPOCHS
CALLS = {
    "rollout": 1, "rollout/policy": STEPS, "rollout/stateless_step": STEPS,
    "rollout/conditional_reset": STEPS, "gae": 1, "update": 1,
    "update/loss_grad": UPDATES, "update/optimizer": UPDATES,
}


@pytest.fixture(autouse=True)
def spans_off():
    metrics.disable()
    metrics.reset()
    yield
    metrics.disable()
    metrics.reset()


@pytest.fixture(scope="module")
def trainer():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small tensors: one thread a test worker
    env = AdvancedForestFireBulldozerEnv(SIZE, SIZE, key=rng.key(7, device="cpu"), num_envs=N,
                                         use_fused_ca=True, device="cpu")
    args = Args(ppo=PPOArgs(num_minibatches=MINIBATCHES, update_epochs=EPOCHS),
                env=EnvArgs(num_envs=N, size=SIZE),
                exp=ExperimentArgs(num_ppo_steps=STEPS, seed=7))
    yield PPOTrainer(env, args, rng.key(7, device="cpu"), device="cpu")
    torch.set_num_threads(threads)


def start(trainer):
    obs, info = trainer.env.reset()
    return (trainer.agent_state, EpisodeStatistics.create(N, "cpu"), obs,
            torch.zeros(N, dtype=torch.bool), info, trainer.key)


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


def test_an_iteration_counts_its_calls_under_each_path(trainer):
    carry = start(trainer)
    metrics.enable()
    trainer.train_iteration(*carry)
    snap = metrics.snapshot()
    assert {p: snap[p][0] for p in CALLS} == CALLS
    # the env's and the key chain's spans lie under the rollout, the
    # permutation's under the update, and nothing lies outside the three roots
    assert {"rollout/stateless_step/ca", "rollout/conditional_reset/fresh_state",
            "rollout/policy/rng", "update/rng"} <= set(snap)
    assert {p.split("/", 1)[0] for p in snap} == {"rollout", "gae", "update"}
    for path, (_, total, child) in snap.items():
        below = [p for p in snap if p.rsplit("/", 1)[0] == path and p != path]
        assert child == sum(snap[p][1] for p in below) <= total, path


def test_the_counters_count_the_samples(trainer):
    names = ("samples_collected", "samples_forward", "samples_trained",
             "policy_graph_captures", "policy_graph_replays")
    before = {k: getattr(trainer, k) for k in names}
    trainer.train_iteration(*start(trainer))  # spans off: the counters count all the same
    moved = {k: getattr(trainer, k) - before[k] for k in names}
    # the CPU runs the policy's eager body: no graph captured or replayed
    assert moved == {"samples_collected": N * STEPS, "samples_forward": N * STEPS + N,
                     "samples_trained": EPOCHS * N * STEPS, "policy_graph_captures": 0,
                     "policy_graph_replays": 0}


def test_an_iteration_is_equal_with_spans_on_and_off(trainer):
    carry = start(trainer)
    kept = [t.clone() for t in leaves(carry)]
    off = leaves(trainer.rollout(*carry)) + leaves(trainer.train_iteration(*carry))
    metrics.enable()
    on = leaves(trainer.rollout(*carry)) + leaves(trainer.train_iteration(*carry))
    assert metrics.snapshot() and len(on) == len(off) > 50
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the iteration is a function of its carry: the carry is left as it was
    assert all(torch.equal(a, b) for a, b in zip(leaves(carry), kept))


def test_the_policy_on_the_cpu_is_the_eager_body_and_captures_no_graph(trainer):
    obs, _ = trainer.env.reset()
    state, key = trainer.agent_state, trainer.key
    forward = trainer.samples_forward
    metrics.enable()
    got = trainer.get_action_and_value(state, obs, key)
    snap = metrics.snapshot()
    metrics.disable()
    want = trainer._policy_eager(state.params, obs[0], trainer._policy_features(obs[1]), key)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert trainer.samples_forward == forward + N
    assert (trainer.policy_graph_captures, trainer.policy_graph_replays) == (0, 0)
    assert trainer._policy_graphs == {}
    assert snap["policy"][0] == 1 and "policy/rng" in snap
    assert not any(p.rsplit("/", 1)[-1] == "policy_graph" for p in snap)


@pytest.mark.parametrize("change", ["grid_shape", "grid_dtype", "feats", "cudnn_tf32",
                                    "cudnn_deterministic", "cudnn_benchmark", "matmul_tf32"])
def test_the_policy_graphs_signature_reads_what_the_capture_depends_on(trainer, change):
    """Each input that changes what a capture holds gives another signature,
    so a caller that changes it gets a new graph, never a stale replay."""
    grid = torch.zeros(N, SIZE, SIZE, 3)
    feats = None
    base = trainer._policy_signature(grid, feats)
    assert trainer._policy_signature(grid.clone(), feats) == base
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark, matmul.allow_tf32
    try:
        if change == "grid_shape":
            grid = grid[:1]
        elif change == "grid_dtype":
            grid = grid.to(torch.uint8)
        elif change == "feats":
            feats = torch.zeros(N, 2)
        elif change == "cudnn_tf32":
            cudnn.allow_tf32 = not cudnn.allow_tf32
        elif change == "cudnn_deterministic":
            cudnn.deterministic = not cudnn.deterministic
        elif change == "cudnn_benchmark":
            cudnn.benchmark = not cudnn.benchmark
        else:
            matmul.allow_tf32 = not matmul.allow_tf32
        assert trainer._policy_signature(grid, feats) != base
    finally:
        cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark, matmul.allow_tf32 = saved
    assert trainer._policy_signature(torch.zeros(N, SIZE, SIZE, 3), None) == base


def test_the_rollout_on_the_cpu_runs_the_eager_env_half_and_captures_no_graph(trainer):
    carry = start(trainer)
    collected = trainer.samples_collected
    metrics.enable()
    trainer.rollout(*carry)
    snap = metrics.snapshot()
    metrics.disable()
    assert trainer.samples_collected == collected + N * STEPS
    assert (trainer.step_graph_captures, trainer.step_graph_replays) == (0, 0)
    assert trainer._step_graphs == {}
    assert {p: snap[p][0] for p in ("rollout", "rollout/policy", "rollout/stateless_step",
                                    "rollout/conditional_reset")} == {
        "rollout": 1, "rollout/policy": STEPS, "rollout/stateless_step": STEPS,
        "rollout/conditional_reset": STEPS}
    assert {"rollout/stateless_step/ca", "rollout/stateless_step/observe",
            "rollout/conditional_reset/fresh_state", "rollout/conditional_reset/observe",
            "rollout/policy/rng"} <= set(snap)
    assert not any("step_graph" in p or "policy_graph" in p for p in snap)


class EagerGraph:
    """Stands in for ``ppo._Graph`` on the CPU with a CUDA graph's buffers:
    static copies of the arguments, the warm-ups and the "capture" run on
    them, and a replay that runs the body on them again."""

    WARMUP = ppo._Graph.WARMUP

    def __init__(self, fn, *args):
        self.fn, self.args = fn, ppo._tree_map(torch.clone, args)
        for _ in range(self.WARMUP):
            fn(*self.args)
        self.out = fn(*self.args)

    def replay(self):
        self.fn(*self.args)


@pytest.mark.parametrize("flags", [
    {}, {"position_features": True, "shape_tree_coef": 20.0, "shape_dist_coef": 2.0,
         "shape_douse_coef": 20.0, "kickstart_coef": 1.0}])
def test_the_step_graphs_buffers_give_the_eager_rollout(trainer, monkeypatch, flags):
    """``_rollout_graphed`` on a stand-in graph (``EagerGraph``) equals the
    eager rollout leaf for leaf, twice from one carry, and leaves that
    carry as it was; it hands back the caller's own terrain and shared
    context, and a new tensor for every other leaf of its carry."""
    env = trainer.env
    exp = {k: v for k, v in flags.items() if k == "position_features"}
    args = Args(ppo=PPOArgs(num_minibatches=MINIBATCHES, update_epochs=EPOCHS,
                            **{k: v for k, v in flags.items() if k not in exp}),
                env=EnvArgs(num_envs=N, size=SIZE),
                exp=ExperimentArgs(num_ppo_steps=STEPS, seed=7, **exp))
    t = PPOTrainer(env, args, rng.key(7, device="cpu"), device="cpu")
    carry = start(t)
    kept = [x.clone() for x in leaves(carry)]
    want = t.rollout(*carry)
    monkeypatch.setattr(ppo, "_Graph", EagerGraph)
    got = [t._rollout_graphed(carry[0], carry[1:5], carry[5]) for _ in range(2)]
    assert (t.step_graph_captures, t.step_graph_replays) == (1, 2 * STEPS)
    for g in got:
        assert len(leaves(g)) == len(leaves(want)) > 50
        for a, b in zip(leaves(g), leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(leaves(carry), kept))
    context = carry[2][1]
    passed = {id(v) for v in context["shared_context"].values()} | {
        id(context["per_env_context"][k]) for k in TERRAIN_KEYS}
    for (path, a), (_, b) in zip(ppo._leaves(got[0][0][1:5]), ppo._leaves(carry[1:5])):
        assert (a is b) == (id(b) in passed), path


@pytest.mark.parametrize("change", ["leaf_shape", "leaf_dtype", "steps", "shaping", "kickstart",
                                    "features", "ca_route", "cudnn_tf32", "cudnn_deterministic",
                                    "cudnn_benchmark", "matmul_tf32"])
def test_the_step_graphs_signature_reads_what_the_capture_depends_on(trainer, change):
    """Each input or setting that changes what a step capture holds gives
    another signature, so a caller that changes it gets a new graph."""
    def signature(carry):
        action = torch.zeros(N, trainer.n_action_heads, dtype=torch.int32)
        lp, value = torch.zeros(N, trainer.n_action_heads), torch.zeros(N)
        return trainer._step_signature((torch.zeros(1, dtype=torch.int64), action, lp, value,
                                        carry[1:5]))

    carry = start(trainer)
    base = signature(carry)
    assert signature(start(trainer)) == base
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark, matmul.allow_tf32,
             trainer.args.exp.num_ppo_steps, trainer._shaping, trainer.args.ppo.shape_tree_coef,
             trainer._kickstart, trainer.position_features, trainer.env.use_fused_ca)
    try:
        if change == "leaf_shape":
            carry = carry[:2] + ((carry[2][0][:1], carry[2][1]),) + carry[3:]
        elif change == "leaf_dtype":
            carry = carry[:3] + (carry[3].to(torch.uint8),) + carry[4:]
        elif change == "steps":
            trainer.args.exp.num_ppo_steps = STEPS + 1
        elif change == "shaping":
            trainer._shaping, trainer.args.ppo.shape_tree_coef = True, 20.0
        elif change == "kickstart":
            trainer._kickstart = True
        elif change == "features":
            trainer.position_features = True
        elif change == "ca_route":
            trainer.env.use_fused_ca = not trainer.env.use_fused_ca
        elif change == "cudnn_tf32":
            cudnn.allow_tf32 = not cudnn.allow_tf32
        elif change == "cudnn_deterministic":
            cudnn.deterministic = not cudnn.deterministic
        elif change == "cudnn_benchmark":
            cudnn.benchmark = not cudnn.benchmark
        else:
            matmul.allow_tf32 = not matmul.allow_tf32
        assert signature(carry) != base
    finally:
        (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark, matmul.allow_tf32,
         trainer.args.exp.num_ppo_steps, trainer._shaping, trainer.args.ppo.shape_tree_coef,
         trainer._kickstart, trainer.position_features, trainer.env.use_fused_ca) = saved
    assert signature(start(trainer)) == base
