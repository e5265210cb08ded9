"""The contract tests of ``tests/test_ppo.py``, on the port's trainer, on the
CPU: the iteration contract, determinism, checkpoints, ``load_actor``,
extension-accuracy gating, shaping and position features, behaviour
cloning, critic warmup, kickstarting and the warmup+kickstart schedule;
then the training entry point ``python3 -m gymca_torch.run``.

Sizes as ``tests/test_ppo.py``: 4 envs x 16², 8 steps per iteration.  The
parity of each part with the JAX trainer is held in
``tests/test_torch_ppo.py``.
"""

import numpy as np
import pytest
import torch

from gymca_torch import rng
from gymca_torch.agents.args import Args, EnvArgs, ExperimentArgs, PPOArgs, VisualizationArgs
from gymca_torch.agents.checkpoint import CheckpointManager
from gymca_torch.agents.ppo import EpisodeStatistics, PPOTrainer, gae, load_actor
from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv

N_ENVS, SIZE = 4, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tensors here are small: one intra-op thread keeps parallel
    test workers (pytest-xdist) from oversubscribing the cores, which made
    this file many times slower than it runs alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_args(**exp_kw):
    return Args(
        ppo=PPOArgs(num_minibatches=2, update_epochs=2),
        env=EnvArgs(num_envs=N_ENVS, size=SIZE),
        viz=VisualizationArgs(),
        exp=ExperimentArgs(total_timesteps=N_ENVS * 8 * 4, num_ppo_steps=8, seed=3, **exp_kw),
    )


def key(seed):
    return rng.key(seed, device="cpu")


def make_env(**kw):
    return AdvancedForestFireBulldozerEnv(SIZE, SIZE, key=key(0), num_envs=N_ENVS,
                                          device="cpu", **kw)


def make_trainer(env, args=None, seed=1):
    return PPOTrainer(env, args or small_args(), key(seed), device="cpu")


@pytest.fixture(scope="module")
def env():
    return make_env()


@pytest.fixture(scope="module")
def trainer(env):
    return make_trainer(env)


def _carry(trainer, env):
    obs, info = env.reset()
    stats = EpisodeStatistics.create(N_ENVS, "cpu")
    return (trainer.agent_state, stats, obs, torch.zeros(N_ENVS, dtype=torch.bool), info,
            trainer.key)


def params_of(state, group):
    return list(state.params[group].values())


def all_params(state):
    return [t for g in state.params for t in params_of(state, g)]


@pytest.mark.parametrize("fused", [False, True])
def test_train_iteration_contract(env, fused):
    """Finite metrics, params moved, the count advanced; on the XLA-path
    counterpart and on the fused kernel's path (its plain version here)."""
    env = env if not fused else make_env(use_fused_ca=True)
    trainer = make_trainer(env)
    st, stats, obs, done, info, k = _carry(trainer, env)
    st2, stats2, obs2, done2, info2, k2, metrics = trainer.train_iteration(
        st, stats, obs, done, info, k)
    for name in ("loss", "policy_loss", "value_loss", "entropy_loss", "approx_kl",
                 "episodic_return"):
        assert name in metrics, name
        assert np.isfinite(float(metrics[name])), name
    assert any(not torch.allclose(a, b) for a, b in zip(all_params(st), all_params(st2)))
    assert int(st2.step) > int(st.step)
    assert not torch.equal(k2, k)


def test_train_iteration_deterministic(trainer, env):
    """Same carry -> bit-identical metrics and params (the iteration leaves
    its inputs untouched)."""
    carry = _carry(trainer, env)
    out1 = trainer.train_iteration(*carry)
    out2 = trainer.train_iteration(*carry)
    for k in out1[-1]:
        assert float(out1[-1][k]) == float(out2[-1][k]), k
    for a, b in zip(all_params(out1[0]), all_params(out2[0])):
        assert torch.equal(a, b)


def test_gae_matches_numpy_oracle():
    """The port's GAE against the CleanRL recurrence in numpy, rtol 2e-5."""
    T, N = 6, N_ENVS
    r = np.random.default_rng(0)
    rewards = r.normal(size=(T, N)).astype(np.float32)
    values = r.normal(size=(T, N)).astype(np.float32)
    dones = (r.random((T, N)) < 0.2).astype(np.float32)
    next_value = r.normal(size=(N,)).astype(np.float32)
    next_done = (r.random(N) < 0.2).astype(np.float32)
    gamma, lam = 0.99, 0.95
    adv = np.zeros((T, N), np.float32)
    lastgaelam = np.zeros(N, np.float32)
    for t in reversed(range(T)):
        if t == T - 1:
            nextnonterminal, nextvalues = 1.0 - next_done, next_value
        else:
            nextnonterminal, nextvalues = 1.0 - dones[t + 1], values[t + 1]
        delta = rewards[t] + gamma * nextvalues * nextnonterminal - values[t]
        lastgaelam = delta + gamma * lam * nextnonterminal * lastgaelam
        adv[t] = lastgaelam
    got = gae(*(torch.from_numpy(x) for x in (rewards, values, dones, next_value, next_done)),
              gamma, lam)
    np.testing.assert_allclose(got.numpy(), adv, rtol=2e-5, atol=2e-5)


def test_checkpoint_roundtrip(tmp_path, trainer, env):
    """Params, optimizer state, count, key and an env carry come back bit for
    bit; two steps are kept."""
    st, stats, obs, done, info, k = _carry(trainer, env)
    out = trainer.train_iteration(st, stats, obs, done, info, k)
    st2, k2 = out[0], out[5]
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    for step in (3, 5, 7):
        mgr.save_state(step, st2, k2, env_carry={"grid": out[2][0]})
    assert mgr.latest_step() == 7
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["5", "7"]
    restored, rkey, carry = mgr.restore_state(trainer.agent_state, trainer.key,
                                              env_carry={"grid": obs[0]})
    for a, b in zip(all_params(restored), all_params(st2)):
        assert torch.equal(a, b)
    for tree in ("mu", "nu"):
        for g in st2.params:
            for n in st2.params[g]:
                assert torch.equal(getattr(restored.opt_state, tree)[g][n],
                                   getattr(st2.opt_state, tree)[g][n])
    assert int(restored.opt_state.count) == int(st2.opt_state.count) == int(restored.step)
    assert torch.equal(rkey, k2)
    assert torch.equal(carry["grid"], out[2][0])
    mgr.close()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore_state(trainer.agent_state,
                                                                 trainer.key)


def test_load_actor_greedy(tmp_path, trainer, env):
    mgr = CheckpointManager(str(tmp_path / "ckpt2"))
    mgr.save_state(1, trainer.agent_state, trainer.key)
    get_action = load_actor(str(tmp_path / "ckpt2"), env, device="cpu")
    obs, _ = env.reset()
    a1, a2 = get_action(obs[0]), get_action(obs[0])
    assert a1.shape[0] == N_ENVS and a1.shape[1] >= 2 and a1.dtype == torch.int32
    assert torch.equal(a1, a2)  # greedy
    assert (a1[:, 0] < 9).all() and (a1[:, 1] < 2).all()


def test_extension_accuracy_gated_off(trainer, env):
    """enable_extensions=False: the extension head is inert, so the accuracy
    metrics are absent and the counters never move."""
    assert not trainer._track_extension_accuracy
    out = trainer.train_iteration(*_carry(trainer, env))
    stats2, metrics = out[1], out[-1]
    assert "day_accuracy" not in metrics and "night_accuracy" not in metrics
    for f in ("current_day_correct", "current_night_correct", "recent_day_correct",
              "recent_night_correct"):
        assert int(getattr(stats2, f).sum()) == 0, f


def test_extension_accuracy_present_when_enabled():
    env = make_env(enable_extensions=True)
    trainer = make_trainer(env)
    assert trainer._track_extension_accuracy
    metrics = trainer.train_iteration(*_carry(trainer, env))[-1]
    for k in ("day_accuracy", "night_accuracy"):
        assert k in metrics
        assert 0.0 <= float(metrics[k]) <= 1.0


def test_reward_shaping_and_position_features(env):
    """Shaping changes the training reward but not the statistics;
    position_features widens the actor/critic input by 2."""
    shaped = make_trainer(env, Args(
        ppo=PPOArgs(num_minibatches=2, update_epochs=2, shape_tree_coef=1.0,
                    shape_dist_coef=0.5),
        env=EnvArgs(num_envs=N_ENVS, size=SIZE), viz=VisualizationArgs(),
        exp=ExperimentArgs(total_timesteps=N_ENVS * 8 * 2, num_ppo_steps=8, seed=3,
                           position_features=True)))
    plain = make_trainer(env)
    assert shaped._shaping and not plain._shaping
    carry = _carry(plain, env)
    m_shaped = shaped.train_iteration(shaped.agent_state, *carry[1:])[-1]
    m_plain = plain.train_iteration(plain.agent_state, *carry[1:])[-1]
    assert float(m_shaped["mean_reward"]) != float(m_plain["mean_reward"])
    w_shaped = shaped.agent_state.params["actor_params"]["Dense_0.weight"]
    w_plain = plain.agent_state.params["actor_params"]["Dense_0.weight"]
    assert w_shaped.shape[1] == w_plain.shape[1] + 2


def test_potential_is_policy_invariant_form(env):
    """phi is a pure function of state, and moving the agent onto the fire
    raises it when dist_coef > 0."""
    t = make_trainer(env, Args(
        ppo=PPOArgs(shape_dist_coef=1.0), env=EnvArgs(num_envs=N_ENVS, size=SIZE),
        viz=VisualizationArgs(), exp=ExperimentArgs(total_timesteps=1, num_ppo_steps=8, seed=3)))
    obs, _ = env.reset()
    ctx = obs[1]
    phi1, phi2 = t._potential(ctx), t._potential(ctx)
    assert torch.equal(phi1, phi2)
    tg = ctx["per_env_context"]["true_grid"]
    fire_pos = torch.nonzero(tg[0] == 2)[0]
    ctx_near = dict(ctx)
    ctx_near["position"] = fire_pos.to(torch.int32).expand(N_ENVS, 2).clone()
    assert float(t._potential(ctx_near)[0]) > float(phi1[0])


def test_bc_pretrain_clones_demonstrator(env):
    """The argmax policy moves toward the greedy-fire demonstrator; the actor
    changes and the critic is untouched."""
    tr = make_trainer(env, small_args(centroid_features=True), seed=5)
    before = tr.agent_state.params
    history = []
    tr.bc_pretrain(30, log_fn=lambda it, m: history.append(m))
    early_loss = np.mean([h["bc_loss"] for h in history[:5]])
    late = history[-1]
    assert late["bc_loss"] < early_loss, (early_loss, history)
    assert late["bc_match"] > 0.6, history
    after = tr.agent_state.params
    assert any(not torch.allclose(a, b) for a, b in zip(before["actor_params"].values(),
                                                        after["actor_params"].values()))
    assert all(torch.equal(a, b) for a, b in zip(before["critic_params"].values(),
                                                 after["critic_params"].values()))


def test_greedy_demo_action_contract(trainer, env):
    obs, _ = env.reset()
    acts = trainer._greedy_demo_action(obs[1])
    assert acts.shape == (N_ENVS, trainer.n_action_heads)
    assert ((acts[:, 0] >= 0) & (acts[:, 0] <= 8)).all()
    assert (acts[:, 1] == 1).all()
    assert (acts[:, 2:] == 0).all()


def test_critic_warmup_freezes_torso_and_actor(env):
    """critic_only iterations update only the critic; torso and actor params
    stay bit-identical while the optimizer's count and moments advance (zero
    gradients go through the chain, as in the JAX trainer)."""
    tr = make_trainer(env, seed=9)
    st, stats, obs, done, info, k = _carry(tr, env)
    st2 = tr.train_iteration(st, stats, obs, done, info, k, 0.0, critic_only=True)[0]
    for g in ("network_params", "actor_params"):
        assert all(torch.equal(a, b) for a, b in zip(params_of(st, g), params_of(st2, g))), g
    assert any(not torch.allclose(a, b) for a, b in zip(params_of(st, "critic_params"),
                                                        params_of(st2, "critic_params")))
    assert int(st2.opt_state.count) == 4


def test_kickstart_ce_pulls_toward_demonstrator(env):
    args = small_args(centroid_features=True)
    args.ppo.kickstart_coef = 5.0
    tr = make_trainer(env, args, seed=11)
    st, stats, obs, done, info, k = _carry(tr, env)

    def demo_logp(params):
        demo = tr._greedy_demo_action(obs[1])
        feats = tr._policy_features(obs[1])
        with torch.no_grad():
            return float(tr.get_action_and_value2(params, (obs[0], feats), demo, demo)[3].mean())

    before = demo_logp(st.params)
    out = tr.train_iteration(st, stats, obs, done, info, k, 5.0)
    assert demo_logp(out[0].params) > before
    assert np.isfinite(float(out[-1]["loss"]))


def test_train_with_warmup_and_kickstart_schedule(env):
    args = small_args(centroid_features=True, critic_warmup_iters=1)
    args.ppo.kickstart_coef = 1.0
    args.ppo.kickstart_decay_iters = 2
    tr = make_trainer(env, args, seed=13)
    _, history = tr.train(num_iterations=3)
    assert len(history) == 3
    assert all(np.isfinite(h["loss"]) for h in history)
    assert history[-1]["global_step"] == 3 * args.batch_size


def test_trainer_asks_for_the_card_by_default(env):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PPOTrainer(env, small_args(), key(1))


# --- python3 -m gymca_torch.run ---------------------------------------------------------

RUN_ARGS = ["--num-envs", "4", "--size", "16", "--num-ppo-steps", "8", "--steps", "64",
            "--num-minibatches", "2", "--update-epochs", "2"]


def test_run_trains_on_the_cpu(tmp_path, capsys):
    """Two iterations (64 steps of 4 envs x 8) with ``--device-cpu``; the
    final params are saved."""
    from gymca_torch import run

    assert run.main(RUN_ARGS + ["--device-cpu", "--out-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "iter 1: SPS=" in out
    saved = list(tmp_path.glob("*_params.pt"))
    assert len(saved) == 1
    params = torch.load(saved[0], weights_only=True)
    assert set(params) == {"network_params", "actor_params", "critic_params"}
    args = run.args_to_structured_args(run.parse_args(RUN_ARGS))
    assert args.num_iterations == 2 and args.batch_size == 32


def test_run_raises_without_a_card(tmp_path):
    from gymca_torch import run

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(RUN_ARGS + ["--out-dir", str(tmp_path)])


@pytest.mark.parametrize("flags", [["--no-train"], ["--gif"], ["--actor", "scripted"],
                                   ["--params", "ckpt"], ["--track"], ["--video-every", "1"]])
def test_run_flags_not_ported_raise(flags, tmp_path, capsys):
    """The flags that raised ``NotImplementedError`` before evaluation and
    ``MetricsLogger`` were ported now run (the name is kept from then).  The
    evaluation flags run 2 steps of 1 env with ``--no-train`` (a missing
    ``--params`` checkpoint raises ``FileNotFoundError``); ``--track`` and
    ``--video-every`` train, logging through ``MetricsLogger``."""
    from gymca_torch import run

    out = ["--device-cpu", "--out-dir", str(tmp_path)]
    if flags[0] in ("--track", "--video-every"):
        assert run.main(RUN_ARGS + ["--steps", "32"] + flags + out) == 0
        runs = next((tmp_path / "runs").iterdir())
        assert list(runs.glob("events.out.tfevents.*"))
        if flags[0] == "--video-every":
            assert (runs / "rollout_32.gif").exists()
        return
    evaluation = ["--no-train", "--num-envs", "1", "--size", "16", "--steps", "2"]
    if flags[0] == "--params":
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            run.main(evaluation + flags + out)
        return
    assert run.main(evaluation + flags + out) == 0
    assert "eval: 2 steps" in capsys.readouterr().out
    assert (tmp_path / "terrain_altitude_env0.png").exists()
    assert (tmp_path / "env0.gif").exists() == (flags[0] == "--gif")
