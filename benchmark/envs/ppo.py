"""The PPO trainer under test: ``gymca_torch``'s ``PPOTrainer`` on the Advanced
env, built as ``python3 -m gymca_torch.run`` trains.

The env is ``AdvancedForestFireBulldozerEnv`` built as the Advanced cell
builds it (``benchmark/envs/advanced.py``: the configuration's settings,
``gymca_torch.run.build_env``'s, plus the benchmark's hidden terrain handed
to the env and the reference alike); the trainer is
``PPOTrainer(env, args, key(seed))`` with the
configuration's PPO arguments and the traffic's batch, the env key also
``key(seed)``, as ``gymca_torch.run.train`` builds them.  An iteration is
``train_iteration`` on the carry ``PPOTrainer.train`` threads, followed by
the same one host fetch of its metrics that ``train`` makes.

:meth:`System.replay` runs one iteration again from its input carry
through the same entry point, with recorders on the trainer's own
``learn``, ``_ppo_loss`` and ``apply_gradients`` (instance attributes that
call the real methods and change no arithmetic) and on
``gymca_torch.rng.permutation`` while ``learn`` runs (the epochs' orders):
the record of what the program computed that
:func:`benchmark.reference.ppo.check` holds to the plain reference.
"""

from __future__ import annotations

import torch

from benchmark.envs.advanced import INFO, PER_ENV, inputs  # noqa: F401 (the control's)
from benchmark.envs.advanced import System as AdvancedSystem
from benchmark.reference import keys as K

COUNTERS = ("samples_collected", "samples_forward", "samples_trained")


def env_state(obs, info) -> dict:
    """The env's state of a carry in the reference's leaves."""
    rgb, context = obs
    s = {k: context["per_env_context"][k] for k in PER_ENV}
    s.update({k: info[k] for k in INFO})
    s.update(rgb=rgb, position=context["position"], time=context["time"])
    return s


def _opt(opt_state) -> dict:
    return {"count": opt_state.count, "mu": opt_state.mu, "nu": opt_state.nu}


class System(AdvancedSystem):
    """The Advanced cell's env (``self.env``, ``self.inputs``) and the
    trainer on it (``self.trainer``)."""

    def __init__(self, cfg: dict, envs: int, seed: int, device):
        from gymca_torch.agents.args import Args, EnvArgs, ExperimentArgs, PPOArgs
        from gymca_torch.agents.ppo import PPOTrainer

        super().__init__(cfg, envs, seed, device)
        self.dev = torch.device(device)
        ppo = cfg["ppo"]
        args = Args(
            ppo=PPOArgs(learning_rate=ppo["learning_rate"], anneal_lr=ppo["anneal_lr"],
                        gamma=ppo["gamma"], gae_lambda=ppo["gae_lambda"],
                        num_minibatches=ppo["num_minibatches"],
                        update_epochs=ppo["update_epochs"], norm_adv=ppo["norm_adv"],
                        clip_coef=ppo["clip_coef"], clip_vloss=ppo["clip_vloss"],
                        ent_coef=ppo["ent_coef"], vf_coef=ppo["vf_coef"],
                        max_grad_norm=ppo["max_grad_norm"]),
            env=EnvArgs(num_envs=envs, size=cfg["nrows"], speed_move=cfg["speed_move"],
                        speed_multiplier=cfg["speed_multiplier"], use_hidden=cfg["use_hidden"],
                        enable_extensions=cfg["enable_extensions"],
                        ca_repeat_mode=cfg["ca_repeat_mode"]),
            exp=ExperimentArgs(seed=int(seed) & K.M32, total_timesteps=ppo["total_timesteps"],
                               num_ppo_steps=ppo["num_steps"],
                               bf16_compute=cfg["bf16_compute"]))
        self.trainer = PPOTrainer(self.env, args, K.key(seed, device), device=device)

    def batch(self) -> dict:
        """The iteration's batch, in the traffic's names."""
        a = self.trainer.args
        return {"envs": a.env.num_envs, "rollout_steps": a.exp.num_ppo_steps,
                "minibatches": a.ppo.num_minibatches, "epochs": a.ppo.update_epochs}

    def start(self):
        """The carry ``PPOTrainer.train`` starts from."""
        from gymca_torch.agents.ppo import EpisodeStatistics

        t = self.trainer
        obs, info = self.env.reset()
        n = t.args.env.num_envs
        done = torch.zeros(n, dtype=torch.bool, device=self.dev)
        return (t.agent_state, EpisodeStatistics.create(n, self.dev), obs, done, info, t.key)

    def iterate(self, carry):
        """One iteration and its one host fetch: (the next carry, metrics)."""
        *carry, metrics = self.trainer.train_iteration(*carry)
        values = torch.stack([v.to(torch.float64) for v in metrics.values()]).tolist()
        return tuple(carry), dict(zip(metrics, values))

    def counters(self):
        """The trainer's work counters, None where the program has none."""
        found = {k: getattr(self.trainer, k, None) for k in COUNTERS}
        return None if None in found.values() else found

    def replay(self, carry):
        """The iteration from ``carry`` run again: (its next carry, the record
        of what it computed)."""
        from gymca_torch import rng

        t = self.trainer
        agent_state, _, obs, done, info, _ = carry
        mbs, learned, orders = [], {}, []
        real = {name: getattr(t, name) for name in ("learn", "_ppo_loss", "apply_gradients")}
        real_permutation = rng.permutation

        def permutation(keys, n):
            out = real_permutation(keys, n)
            orders.append(out)
            return out

        def learn(state, next_obs, next_done, storage, key, *args, **kw):
            first = len(orders)
            out = real["learn"](state, next_obs, next_done, storage, key, *args, **kw)
            learned.update(next_obs=next_obs, next_done=next_done, storage=out[3],
                           orders=orders[first:])
            return out

        def ppo_loss(params, x, a, logp, adv, ret, val, *args, **kw):
            loss, aux = real["_ppo_loss"](params, x, a, logp, adv, ret, val, *args, **kw)
            mbs.append({"grid": x[0], "actions": a, "logprobs": logp, "advantages": adv[:, 0],
                        "advantage_heads": adv, "returns": ret, "values": val,
                        "losses": torch.stack([loss.detach()] + [v.detach() for v in aux])})
            return loss, aux

        def apply_gradients(state, grads):
            new = real["apply_gradients"](state, grads)
            mbs[-1].update(params=state.params, opt=_opt(state.opt_state), grads=grads,
                           params_after=new.params, opt_after=_opt(new.opt_state))
            return new

        t.learn, t._ppo_loss, t.apply_gradients = learn, ppo_loss, apply_gradients
        rng.permutation = permutation
        try:
            out, _ = self.iterate(carry)
        finally:
            rng.permutation = real_permutation
            for name in real:
                delattr(t, name)
        s = learned["storage"]
        record = {
            "params": agent_state.params, "opt": _opt(agent_state.opt_state),
            "env_start": env_state(obs, info), "done_start": done,
            "actions": s.actions, "grid_obs": s.grid_obs, "dones": s.dones,
            "rewards": s.rewards, "logprobs": s.logprobs, "values": s.values,
            "advantages": s.advantages, "returns": s.returns,
            "next_obs": learned["next_obs"][0], "next_done": learned["next_done"],
            "env_end": env_state(out[2], out[4]), "minibatches": mbs,
            "orders": learned["orders"], "params_end": out[0].params,
            "opt_end": _opt(out[0].opt_state),
        }
        return out, record
