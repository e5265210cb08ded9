"""The PPO trainer of the port against the JAX package's, on the CPU.

Weights cross from the JAX trainer to the port with
``gymca_torch.interop.ppo_params_from_numpy``; every other input (grids,
actions, advantages, gradients, env states) is made with numpy from a seed
and handed to both.  The JAX env runs its XLA path (the CPU default at
16²) and the port's env the XLA-path counterpart, which equals it bit for
bit.  Each test states its tolerance.  The JAX trainer is built once per
module (4 envs x 16², 8 steps, as ``tests/test_ppo.py`` builds it): each
build and each jit costs seconds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymca_torch import interop
from gymca_torch.agents import args as targs
from gymca_torch.agents import networks as tnet
from gymca_torch.agents import optim
from gymca_torch.agents import ppo as tppo
from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv as TEnv
from gymca_tpu.agents import args as jargs
from gymca_tpu.agents import networks as jnet
from gymca_tpu.agents import ppo as jppo
from gymca_tpu.envs.advanced import AdvancedForestFireBulldozerEnv as JEnv

N_ENVS, SIZE, STEPS = 4, 16, 8
BF16 = ("exp_slope", "veg_den_factor")
LR = 2.5e-4
PARAM_ATOL = 2e-6  # port against JAX after one train_iteration


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tensors here are small: one intra-op thread keeps parallel
    test workers (pytest-xdist) from oversubscribing the cores, which made
    this file many times slower than it runs alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_args(m, **exp_kw):
    """``tests/test_ppo.py``'s arguments, from the JAX package's or the
    port's ``args`` module ``m``."""
    return m.Args(
        ppo=m.PPOArgs(num_minibatches=2, update_epochs=2),
        env=m.EnvArgs(num_envs=N_ENVS, size=SIZE),
        viz=m.VisualizationArgs(),
        exp=m.ExperimentArgs(total_timesteps=N_ENVS * STEPS * 4, num_ppo_steps=STEPS, seed=3,
                             **exp_kw),
    )


def torch_key(jkey):
    return torch.tensor(np.asarray(jax.random.key_data(jkey)).astype(np.int64))


def port_env(jenv):
    """The port's env on the CPU with the JAX env's key and settings: it
    draws the same terrain from the key."""
    return TEnv(jenv.nrows, jenv.ncols, key=torch_key(jenv.starting_key),
                num_envs=jenv.num_envs, device="cpu")


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def carried(trainer, jparams):
    """``trainer``'s agent state with the JAX trainer's params and a fresh
    optimizer state."""
    params = interop.ppo_params_from_numpy(jax.device_get(dict(jparams)), "cpu")
    return trainer.agent_state.replace(params=params,
                                       opt_state=optim.adam_init(params, LR))


@pytest.fixture(scope="module")
def pair():
    """(JAX env, JAX trainer, port env, port trainer), same terrain, same
    trainer key, the port holding the JAX trainer's weights."""
    jenv = JEnv(SIZE, SIZE, key=jax.random.key(0), num_envs=N_ENVS)
    jt = jppo.PPOTrainer(jenv, small_args(jargs), jax.random.key(1))
    tenv = port_env(jenv)
    tt = tppo.PPOTrainer(tenv, small_args(targs), torch_key(jax.random.key(1)), device="cpu")
    tt.agent_state = carried(tt, jt.agent_state.params)
    return jenv, jt, tenv, tt


def grids(seed, n, size):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


# --- networks -------------------------------------------------------------------------


def flax_models(size, bf16=False):
    """Flax Network, Actor and Critic at ``size``² with their params (batch
    2 of random grids); the actor has the env's heads (9, 2, 3)."""
    net = jnet.Network(compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    actor, critic = jnet.Actor(action_dims=(9, 2), choose_k=((2, 1),)), jnet.Critic()
    k1, k2, k3 = jax.random.split(jax.random.key(size), 3)
    p_net = net.init(k1, jnp.zeros((1, size, size, 3), jnp.uint8))
    hidden = jnp.zeros((1, 128), jnp.float32)
    tree = {"network_params": p_net, "actor_params": actor.init(k2, hidden),
            "critic_params": critic.init(k3, hidden)}
    return (net, actor, critic), jax.device_get(tree)


def port_models(size, tree, bf16=False):
    net = tnet.Network(size, size, compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    actor, critic = tnet.Actor(128, (9, 2), ((2, 1),)), tnet.Critic(128)
    params = interop.ppo_params_from_numpy(tree, "cpu")
    for m, g in ((net, "network_params"), (actor, "actor_params"), (critic, "critic_params")):
        m.load_state_dict(params[g])
    return net, actor, critic


def forward_both(size, bf16):
    (jn, ja, jc), tree = flax_models(size, bf16)
    tn, ta, tc = port_models(size, tree, bf16)
    g = grids(size, 2, size)
    j_hidden = jax.jit(jn.apply)(tree["network_params"], g)
    want = [np.asarray(j_hidden)] + [np.asarray(x) for x in ja.apply(
        tree["actor_params"], j_hidden)] + [np.asarray(jc.apply(tree["critic_params"],
                                                                  j_hidden))]
    with torch.no_grad():
        t_hidden = tn(torch.from_numpy(g))
        got = [t_hidden.numpy()] + [x.numpy() for x in ta(t_hidden)] + [tc(t_hidden).numpy()]
    return got, want


@pytest.mark.parametrize("size", [SIZE, 256])
def test_network_actor_and_critic_match_flax_in_float32(size):
    """Carried weights, batch 2 of random uint8 grids: hidden, the three
    heads' logits and the value within rtol 1e-4, atol 1e-5.  At 256² the
    pools see 126 -> 63 -> 32 -> 16 (SAME padding (0, 1), (1, 1), (0, 1))
    and the first Dense is (16384, 128)."""
    got, want = forward_both(size, bf16=False)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert got[0].shape == (2, 128) and [g.shape[1] for g in got[1:4]] == [9, 2, 3]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    assert np.abs(want[0]).max() > 0.1  # not an all-dead torso


# bf16_compute: max |port - flax| over each output (hidden, the three heads'
# logits, value), divided by that output's largest |flax| value, measured on
# these inputs: 0 to 1.5e-6 at 16² and 2.6e-3 to 1.23e-2 at 256² (hidden
# features reach about 20, where a bfloat16 step is 0.125; the two round the
# layers' sums in different places).  Held at 2e-2 of each output's scale.
BF16_SCALED_ATOL = 2e-2


@pytest.mark.parametrize("size", [SIZE, 256])
def test_bf16_compute_matches_flax(size):
    got, want = forward_both(size, bf16=True)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=BF16_SCALED_ATOL * np.abs(w).max())


def test_param_counts_match_jax(pair):
    """2,328,496 torso params at 256² with the defaults, in both packages;
    and the trainers' counts at 16²."""
    _, tree = flax_models(256)
    tn, ta, tc = port_models(256, tree)
    for m, g in ((tn, "network_params"), (ta, "actor_params"), (tc, "critic_params")):
        assert sum(p.numel() for p in m.parameters()) == sum(
            v.size for v in leaves(tree[g]).values())
    assert sum(p.numel() for p in tn.parameters()) == 2_328_496
    _, jt, _, tt = pair
    assert tt.param_counts == jt.param_counts


@pytest.mark.parametrize("size", [SIZE, 256])
def test_param_converter_round_trip_is_exact(size):
    _, tree = flax_models(size)
    back = interop.ppo_params_to_numpy(interop.ppo_params_from_numpy(tree, "cpu"))
    want, got = leaves(tree), leaves(back)
    assert sorted(want) == sorted(got)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --- GAE, loss, optimizer --------------------------------------------------------------


def test_gae_matches_the_jax_scan(pair):
    """rtol 2e-5, as ``test_gae_matches_numpy_oracle``."""
    T, N = 6, N_ENVS
    r = np.random.default_rng(0)
    rewards, values = (r.normal(size=(T, N)).astype(np.float32) for _ in range(2))
    dones = r.random((T, N)) < 0.2
    next_value = r.normal(size=(N,)).astype(np.float32)
    next_done = r.random(N) < 0.2
    _, jt, _, _ = pair
    gamma, lam = jt.args.ppo.gamma, jt.args.ppo.gae_lambda

    def gae_once(advantages, inp):  # the JAX trainer's scan body
        nextdone, nextvalues, curvalues, reward = inp
        nextnonterminal = 1.0 - nextdone
        delta = reward + gamma * nextvalues * nextnonterminal - curvalues
        advantages = delta + gamma * lam * nextnonterminal * advantages
        return advantages, advantages

    dd = jnp.concatenate([jnp.asarray(dones), jnp.asarray(next_done)[None]], 0)
    vv = jnp.concatenate([jnp.asarray(values), jnp.asarray(next_value)[None]], 0)
    want = jax.jit(lambda: jax.lax.scan(gae_once, jnp.zeros(N), (
        dd[1:].astype(jnp.float32), vv[1:], vv[:-1], jnp.asarray(rewards)), reverse=True)[1])()
    got = tppo.gae(torch.from_numpy(rewards), torch.from_numpy(values), torch.from_numpy(dones),
                   torch.from_numpy(next_value), torch.from_numpy(next_done), gamma, lam)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def minibatch(seed, n=16, heads=3):
    r = np.random.default_rng(seed)
    return dict(
        grid=grids(seed, n, SIZE),
        pos=r.integers(0, SIZE, (n, 2)).astype(np.int32),
        actions=np.stack([r.integers(0, 9, n), r.integers(0, 2, n), r.integers(0, 3, n)],
                         1).astype(np.int32),
        logp=(np.log([1 / 9, 1 / 2, 1 / 3]) + r.normal(0, 0.05, (n, heads))).astype(np.float32),
        adv=np.repeat(r.normal(size=(n, 1)), heads, 1).astype(np.float32),
        returns=r.normal(size=n).astype(np.float32),
        values=r.normal(size=n).astype(np.float32),
        demo=np.stack([r.integers(0, 9, n), np.ones(n), np.zeros(n)], 1).astype(np.int32),
    )


@pytest.mark.parametrize("kickstart", [False, True])
def test_ppo_loss_and_grads_match_jax(pair, monkeypatch, kickstart):
    """``_ppo_loss`` on one fixed minibatch (16 samples, advantages repeated
    over the heads): the loss and its four parts within rtol 1e-4, every
    gradient within rtol 1e-3, atol 1e-6; with and without the kickstart
    term (coefficient 0.7)."""
    _, jt, _, tt = pair
    monkeypatch.setattr(jt, "_kickstart", kickstart)
    monkeypatch.setattr(tt, "_kickstart", kickstart)
    mb = minibatch(3)
    loss_grad = jax.jit(jax.value_and_grad(jt._ppo_loss, has_aux=True))
    (j_loss, j_aux), j_grads = loss_grad(
        jt.agent_state.params, (jnp.asarray(mb["grid"]), jnp.asarray(mb["pos"])),
        *(jnp.asarray(mb[k]) for k in ("actions", "logp", "adv", "returns", "values", "demo")),
        jnp.float32(0.7))
    t = {k: torch.from_numpy(v) for k, v in mb.items()}
    t_loss, t_aux, t_grads = tppo.value_and_grad(
        tt._ppo_loss, tt.agent_state.params, (t["grid"], t["pos"]),
        *(t[k] for k in ("actions", "logp", "adv", "returns", "values", "demo")),
        float(np.float32(0.7)))
    for g, w in zip((t_loss,) + t_aux, (j_loss,) + tuple(j_aux)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4)
    want, got = leaves(jax.device_get(dict(j_grads))), leaves(
        interop.ppo_params_to_numpy(t_grads))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6, err_msg=k)
    assert max(np.abs(v).max() for v in want.values()) > 1e-3


def test_optimizer_updates_match_optax(pair):
    """Five updates from identical gradients through the trainer's chain:
    plain, a critic-only one (zero torso and actor gradients), plain, one
    with gradients under the clip norm, and one past the schedule's horizon
    (count moved to 40 of the 16 planned: the rate clamps at 0).  Params and
    both moments within atol 1e-7, the counts and rates equal."""
    _, jt, _, tt = pair
    r = np.random.default_rng(7)
    paths, treedef = jax.tree_util.tree_flatten_with_path(jt.agent_state.params)
    shapes = {jax.tree_util.keystr(k): v.shape for k, v in paths}

    def grads_np(scale, critic_only=False):
        g = {k: (r.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}
        if critic_only:
            g = {k: (v if "critic_params" in k else np.zeros_like(v)) for k, v in g.items()}
        return g

    def to_tree(g):
        return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(g[k]) for k in shapes])

    j_state, t_state = jt.agent_state, tt.agent_state
    j_apply = jax.jit(lambda state, grads: state.apply_gradients(grads=grads))
    for scale, critic_only, jump in ((0.1, False, None), (0.1, True, None), (0.1, False, None),
                                     (1e-4, False, None), (0.1, False, 40)):
        if jump is not None:
            inject = j_state.opt_state[1]
            adam = inject.inner_state[0]._replace(count=jnp.int32(jump))
            sched = inject.hyperparams_states["learning_rate"]
            inject = inject._replace(
                count=jnp.int32(jump), inner_state=(adam,) + tuple(inject.inner_state[1:]),
                hyperparams_states={"learning_rate": sched._replace(count=jnp.int32(jump))})
            j_state = j_state.replace(opt_state=(j_state.opt_state[0], inject))
            t_state = t_state.replace(opt_state=t_state.opt_state.replace(
                count=torch.tensor(jump, dtype=torch.int32)))
        g = grads_np(scale, critic_only)
        j_tree = to_tree(g)
        j_state = j_apply(j_state, j_tree)
        t_state = tt.apply_gradients(t_state, interop.ppo_params_from_numpy(
            jax.device_get(j_tree), "cpu"))
        inject = j_state.opt_state[1]
        adam = inject.inner_state[0]
        assert int(t_state.opt_state.count) == int(adam.count) == int(inject.count)
        assert int(t_state.step) == int(j_state.step)
        np.testing.assert_allclose(float(t_state.opt_state.learning_rate),
                                   float(inject.hyperparams["learning_rate"]), rtol=1e-6)
        assert (float(t_state.opt_state.learning_rate) == 0.0) == (jump is not None)
        for name, j_tree_, t_tree in (("params", j_state.params, t_state.params),
                                      ("mu", adam.mu, t_state.opt_state.mu),
                                      ("nu", adam.nu, t_state.opt_state.nu)):
            want = leaves(jax.device_get(dict(j_tree_)))
            got = leaves(interop.ppo_params_to_numpy(t_tree))
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-7,
                                           err_msg=f"{name} {k}")


# --- episode statistics, demonstrator, shaping ---------------------------------------------


def stats_inputs(r, n):
    info = {"reward": -r.random(n).astype(np.float32),
            "terminated": r.random(n) < 0.7, "TimeLimit.truncated": r.random(n) < 0.1}
    action = np.stack([r.integers(0, 9, n), r.integers(0, 2, n), r.integers(0, 3, n)], 1)
    return action.astype(np.int32), r.integers(0, 2, n).astype(np.int32), info


def test_episode_statistics_and_ring_buffer_match_jax(pair, monkeypatch):
    """14 envs, 6 steps, day/night accuracy tracked: every leaf of the
    statistics bit for bit after each step, with more than 10 envs finishing
    in one step (ring slots collide: the last env wins in both)."""
    _, jt, _, tt = pair
    monkeypatch.setattr(jt, "_track_extension_accuracy", True)
    monkeypatch.setattr(tt, "_track_extension_accuracy", True)
    n, r = 14, np.random.default_rng(11)
    j_stats, t_stats = jppo.EpisodeStatistics.create(n), tppo.EpisodeStatistics.create(n, "cpu")
    update = jax.jit(jt._update_episode_stats)
    most = 0
    for step in range(6):
        action, night, info = stats_inputs(r, n)
        if step == 2:
            info["terminated"][:] = True
        most = max(most, int((info["terminated"] | info["TimeLimit.truncated"]).sum()))
        j_obs = (None, {"per_env_context": {"is_night": jnp.asarray(night)}})
        t_obs = (None, {"per_env_context": {"is_night": torch.from_numpy(night)}})
        j_stats = update(j_stats, jnp.asarray(action), j_obs,
                         {k: jnp.asarray(v) for k, v in info.items()})
        t_stats = tt._update_episode_stats(t_stats, torch.from_numpy(action), t_obs,
                                           {k: torch.from_numpy(v) for k, v in info.items()})
        for f in ("recent_returns", "recent_lengths", "recent_idx", "amount_finished",
                  "episode_returns", "episode_lengths", "returned_episode_returns",
                  "returned_episode_lengths", "current_day_correct", "current_night_correct",
                  "current_day_steps", "current_night_steps", "recent_day_correct",
                  "recent_night_correct", "recent_day_steps", "recent_night_steps"):
            got, want = getattr(t_stats, f).numpy(), np.asarray(getattr(j_stats, f))
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f"step {step} {f}")
    assert most > 10


def context_from_numpy(seed, n=6, size=SIZE):
    r = np.random.default_rng(seed)
    tg = r.choice(np.int8([0, 1, 2]), size=(n, size, size), p=(0.3, 0.6, 0.1))
    tg[0] = np.where(tg[0] == 2, 1, tg[0])  # env 0 has no fire
    return {"true_grid": tg, "dousing_count": (r.random((n, size, size)) < 0.2).astype(np.int8),
            "position": r.integers(0, size, (n, 2)).astype(np.int32)}


def as_context(c, to):
    return {"per_env_context": {"true_grid": to(c["true_grid"]),
                                "dousing_count": to(c["dousing_count"])},
            "position": to(c["position"])}


def test_demonstrator_features_and_potential_match_jax(pair, monkeypatch):
    """``_greedy_demo_action`` and ``_policy_features`` (position and
    centroid) bit for bit; ``_potential`` with all three shaping terms
    within atol 1e-6 (the JAX functions jitted, as the trainer runs them)."""
    _, jt, _, tt = pair
    for t in (jt, tt):
        for k, v in (("shape_tree_coef", 1.0), ("shape_dist_coef", 0.5),
                     ("shape_douse_coef", 20.0)):
            monkeypatch.setattr(t.args.ppo, k, v)
        for k in ("position_features", "centroid_features", "_use_features"):
            monkeypatch.setattr(t, k, True)
    for seed in (0, 1):
        c = context_from_numpy(seed)
        jc, tc = as_context(c, jnp.asarray), as_context(c, torch.from_numpy)
        np.testing.assert_array_equal(tt._greedy_demo_action(tc).numpy(),
                                      np.asarray(jax.jit(jt._greedy_demo_action)(jc)))
        np.testing.assert_array_equal(tt._policy_features(tc).numpy(),
                                      np.asarray(jax.jit(jt._policy_features)(jc)))
        got, want = tt._potential(tc).numpy(), np.asarray(jax.jit(jt._potential)(jc))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert np.abs(want).max() > 0.1


# --- the whole slice ----------------------------------------------------------------------


def test_train_iteration_matches_jax(pair):
    """One ``train_iteration`` from the same env key, trainer key and
    weights (4 envs x 16², 8 steps, 2 epochs of 2 minibatches):

    * the rollout's actions, rewards, dones, grids and positions bit for bit
      (the JAX rollout is its own ``_step_once`` scanned), logprobs and
      values within atol 1e-5;
    * the env's obs and info leaves after the iteration bit for bit;
    * the metrics within rtol 1e-3;
    * every param within ``PARAM_ATOL`` = 2e-6 of JAX's (the largest gap
      measured on the CPU was 2.2e-7, while each side's update moved a param
      by up to 9.9e-4), and both sides' params moved by more than lr.  An
      update skipped or of the wrong sign leaves a gap near 1e-3 or 2e-3.
    """
    jenv, jt, tenv, tt = pair
    jo, ji = jenv.reset()
    to, ti = tenv.reset()
    jc = (jt.agent_state, jppo.EpisodeStatistics.create(N_ENVS), jo, jnp.full(N_ENVS, False),
          ji, jt.key)
    tc = (tt.agent_state, tppo.EpisodeStatistics.create(N_ENVS, "cpu"), to,
          torch.zeros(N_ENVS, dtype=torch.bool), ti, tt.key)

    _, j_store = jax.jit(lambda c: jax.lax.scan(jt._step_once, c, (), length=STEPS))(jc)
    _, t_store = tt.rollout(*tc)
    for f in ("actions", "rewards", "dones", "grid_obs", "position_obs"):
        got, want = getattr(t_store, f).numpy(), np.asarray(getattr(j_store, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("logprobs", "values"):
        np.testing.assert_allclose(getattr(t_store, f).numpy(), np.asarray(getattr(j_store, f)),
                                   rtol=0, atol=1e-5, err_msg=f)
    assert len(np.unique(np.asarray(j_store.actions)[..., 0])) > 3  # the policy varies

    j_out = jt.train_iteration(*jc)
    t_out = tt.train_iteration(*tc)
    assert_env_equal(t_out[2], t_out[4], j_out[2], j_out[4])
    np.testing.assert_array_equal(t_out[5].numpy(), np.asarray(jax.random.key_data(j_out[5])))
    j_m, t_m = j_out[-1], t_out[-1]
    assert sorted(j_m) == sorted(t_m)
    for k in j_m:
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=1e-3, err_msg=k)
    n_updates = jt.args.ppo.update_epochs * jt.args.ppo.num_minibatches
    start = leaves(jax.device_get(dict(jt.agent_state.params)))
    want = leaves(jax.device_get(dict(j_out[0].params)))
    got = leaves(interop.ppo_params_to_numpy(t_out[0].params))
    gap = max(np.abs(got[k] - want[k]).max() for k in want)
    j_moved = max(np.abs(want[k] - start[k]).max() for k in want)
    t_moved = max(np.abs(got[k] - start[k]).max() for k in want)
    assert gap <= PARAM_ATOL, gap
    assert min(j_moved, t_moved) > LR  # both updates moved the params, by far more than the gap
    assert int(t_out[0].step) == int(j_out[0].step) == n_updates


def assert_env_equal(t_obs, t_info, j_obs, j_info):
    rgb, ctx, info = interop.advanced_obs_to_numpy(t_obs, t_info)
    np.testing.assert_array_equal(rgb, np.asarray(j_obs[0]))
    for k, v in j_obs[1]["per_env_context"].items():
        v = np.asarray(jax.random.key_data(v)) if k == "key" else np.asarray(v)
        np.testing.assert_array_equal(ctx["per_env_context"][k],
                                      v.view(np.uint16) if k in BF16 else v, err_msg=k)
    for k in ("position", "time"):
        np.testing.assert_array_equal(ctx[k], np.asarray(j_obs[1][k]), err_msg=k)
    for k, v in j_info.items():
        np.testing.assert_array_equal(info[k], np.asarray(v), err_msg=k)

