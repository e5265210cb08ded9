"""The port's PPO trainer against the benchmark's plain reference
(``benchmark/reference/ppo.py``), on the CPU: the forward, one minibatch's
losses and gradients, the clip and Adam step, GAE and one whole iteration
through the trainer cell's check.  On the CPU both sides compute in
float32, so each is held to float32 rounding (:data:`TOL`), far inside the
cell's limits, which allow the card's TF32 convolutions; the whole
iteration passes the cell's check as well.  The reference in bfloat16
exceeds a limit of the cell.  Weights are the trainer's own init
from the seed, on a 32² grid with 2 envs, 8 rollout steps, 2 minibatches
and 2 epochs.  Also the benchmark's FLOP count against
``FlopCounterMode``'s count of the port's modules."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops
from benchmark import run as bench_run
from benchmark.envs.ppo import System
from benchmark.reference import ppo as P
from benchmark.terrain import make_terrain
from benchmark.tests import toy_ppo
from gymca_torch.agents import networks
from gymca_torch.agents import ppo as tppo

SEED = 2**31 + 77
CFG = toy_ppo.config()
N = toy_ppo.BATCH["envs"]
L = P.LIMITS
# Relative gaps of float32 against float32, summed in other orders: at
# most 3.4e-5 here (the value loss of 8 samples, where v - R cancels; the
# rest 2e-5 and less), up to 8e-5 on other seeds; TF32 on the card reads
# 1e2-1e4 times more (the cell's LIMITS).
TOL = 1e-4


@pytest.fixture(scope="module")
def system():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small tensors: one thread a test worker
    yield System(CFG, N, SEED, "cpu")
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def record(system):
    """One iteration from the initial carry, run with the recorders."""
    return system.replay(system.start())[1]


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def norm_rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def test_the_forward_equals_the_reference(system, record):
    t, params = system.trainer, record["params"]
    grid = record["grid_obs"].flatten(0, 1)
    hidden = t._torso(params, grid, None)
    logits, value = t._actor_logits(params, hidden), t._value(params, hidden)
    ref_logits, ref_value = P.policy(CFG, params, grid)
    assert [lg.shape for lg in logits] == [lg.shape for lg in ref_logits]
    assert max(rel(a, b) for a, b in zip(logits, ref_logits)) <= TOL
    assert rel(value, ref_value) <= TOL


def minibatch(record, size=8):
    g = torch.Generator().manual_seed(3)
    idx = torch.randperm(record["values"].numel(), generator=g)[:size]
    flat = {k: record[k].flatten(0, 1)[idx] for k in ("grid_obs", "actions", "logprobs",
                                                      "advantages", "returns", "values")}
    return dict(flat, grid=flat.pop("grid_obs"))


def test_a_minibatch_loss_and_gradients_equal_the_reference(system, record):
    t, params, mb = system.trainer, record["params"], minibatch(record)
    heads = mb["actions"].shape[1]
    loss, aux, grads = tppo.value_and_grad(
        t._ppo_loss, params, (mb["grid"], None), mb["actions"], mb["logprobs"],
        mb["advantages"][:, None].expand(-1, heads), mb["returns"], mb["values"],
        torch.zeros_like(mb["actions"]), 0.0)
    losses, ref_grads = P.loss_and_grads(CFG, params, mb)
    gaps = (torch.stack((loss,) + aux).double() - losses.double()).abs()
    for name, gap in zip(P.LOSSES, gaps / P.loss_scales(CFG["ppo"], losses.double())):
        assert gap <= TOL, name
    for g, d in ref_grads.items():
        for k, ref in d.items():
            assert norm_rel(grads[g][k], ref) <= TOL, (g, k)


@pytest.mark.parametrize("scale", [1.0, 1e3], ids=["unclipped", "clipped"])
def test_the_clip_and_adam_step_equal_the_reference(system, record, scale):
    """Two steps from the initial state, the second on moments the first
    made; at 1e3 the gradients' global norm exceeds the clip."""
    t = system.trainer
    state = t.agent_state
    batch = record["values"].numel()
    for mb in record["minibatches"][:2]:
        grads = {g: {k: v * scale for k, v in d.items()} for g, d in mb["grads"].items()}
        new = t.apply_gradients(state, grads)
        opt = {"count": state.opt_state.count, "mu": state.opt_state.mu,
               "nu": state.opt_state.nu}
        params, ref_opt = P.adam(CFG, grads, opt, state.params, batch)
        assert int(new.opt_state.count) == int(ref_opt["count"])
        for g, d in params.items():
            for k, ref in d.items():
                moved = ref - state.params[g][k]
                assert float(torch.linalg.vector_norm(new.params[g][k] - ref)) <= (
                    TOL * float(torch.linalg.vector_norm(moved))), (g, k)
                for m in ("mu", "nu"):
                    assert norm_rel(getattr(new.opt_state, m)[g][k],
                                    ref_opt[m][g][k]) <= TOL, (m, g, k)
        state = new


def test_gae_equals_the_reference():
    g = torch.Generator().manual_seed(5)
    steps, n = 16, 3
    rewards = -torch.rand((steps, n), generator=g)
    values = torch.randn((steps, n), generator=g)
    dones = torch.rand((steps, n), generator=g) < 0.2  # episode starts inside
    next_value, next_done = torch.randn(n, generator=g), torch.tensor([True, False, False])
    hp = CFG["ppo"]
    adv = tppo.gae(rewards, values, dones, next_value, next_done, hp["gamma"],
                   hp["gae_lambda"])
    assert rel(adv, P.gae(hp, rewards, values, dones, next_value, next_done)) <= TOL


def test_a_whole_iteration_passes_the_cells_check(tmp_path):
    """``train_iteration`` in the cell's loop at the toy size, its last
    iteration run again and read by the reference: every number within its
    limit, the counts 0 (the re-run equal to the window bit for bit, the
    optimizer steps chained, the minibatches the storage's rows) and the
    gaps within float32 rounding."""
    spec = bench_run.Spec(toy_ppo.build(tmp_path))
    r = bench_run.run_cell(spec, "ppo-toy", SEED, 0, False, "cpu", max_steps=2)
    assert r["correct"] and set(r["checks"]) == set(L), r["checks"]
    for name, c in r["checks"].items():
        assert c["value"] <= (0 if name.endswith("_values_wrong") else TOL), (name, c)


def test_the_bfloat16_reference_exceeds_a_limit():
    terrain = make_terrain(N, CFG["nrows"], CFG["ncols"], SEED, "cpu")
    numbers = P.check(CFG, P.control_record(CFG, SEED, N, terrain, "cpu"), terrain, "cpu")
    assert set(numbers) == set(L) - {"rerun_values_wrong"}
    assert any(v > L[k] for k, v in numbers.items()), numbers


@pytest.mark.parametrize("passes", ["forward", "forward_backward"])
@pytest.mark.parametrize("size", [64, 256])
def test_the_flop_count_equals_the_flop_counter(size, passes):
    cfg = dict(CFG, nrows=size, ncols=size)
    torch.manual_seed(0)
    net = networks.Network(size, size)
    actor = networks.Actor(128, (9, 2), ((2, 1),))
    critic = networks.Critic(128)
    assert actor.head_dims == tuple(cfg["action_heads"])
    grid = torch.randint(0, 256, (1, size, size, 3), dtype=torch.uint8)
    counter = FlopCounterMode(display=False)
    with counter, torch.set_grad_enabled(passes == "forward_backward"):
        hidden = net(grid)
        out = sum(lg.sum() for lg in actor(hidden)) + critic(hidden).sum()
        if passes == "forward_backward":
            out.backward()
    assert counter.get_total_flops() == getattr(flops, passes)(cfg)
