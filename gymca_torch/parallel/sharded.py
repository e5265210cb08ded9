"""Data-parallel PPO over a process group.

Counterpart of ``gymca_tpu/parallel/sharded.py``: the env batch is cut over
the ``data`` axis of a mesh, each rank steps its own ``N / D`` envs, runs
its rollout and GAE on them, and the ranks average every minibatch's
gradients and losses (``PPOTrainer(process_group=...)``); the params stay
replicated, since every rank applies the same averaged update.

Minibatches are shuffled per rank: each rank permutes its local ``T x N/D``
block, as each device does in the JAX package.  With averaged gradients
this matches global-batch PPO up to the minibatches' composition.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from gymca_torch import rng
from gymca_torch.agents.ppo import EpisodeStatistics, PPOTrainer, group_mean
from gymca_torch.parallel.mesh import axis_rank, axis_size, shard_env_batch

__all__ = ["DataParallelPPO"]


class DataParallelPPO:
    """A ``PPOTrainer`` whose ranks each train on a block of the env batch.

    Every rank of ``mesh`` builds it with the same ``env`` (all
    ``args.env.num_envs`` envs, the same key) and ``args``; ``num_envs`` must
    divide by the size of the mesh's ``axis_name`` axis.  ``device`` is this
    rank's device (the card unless the caller names another).
    """

    def __init__(self, env, args, mesh, key=None, axis_name: str = "data", device=None):
        self.mesh = mesh
        self.axis_name = axis_name
        self.group = mesh.get_group(axis_name)
        self.n_shards = axis_size(mesh, axis_name)
        self.rank = axis_rank(mesh, axis_name)
        assert args.env.num_envs % self.n_shards == 0, (
            f"num_envs={args.env.num_envs} not divisible by mesh axis "
            f"{axis_name}={self.n_shards}")
        self.envs_per_shard = args.env.num_envs // self.n_shards
        self.trainer = PPOTrainer(env, args, key, device=device, process_group=self.group)
        self.env = env
        self.args = args
        self.metric_all_reduces = 0

        # kickstart-CE / critic-warmup iterations, made only when the args
        # ask for those phases (the JAX package compiles a program for each)
        self._ks_warmup = int(getattr(args.exp, "critic_warmup_iters", 0))
        self._ks_coef0 = float(args.ppo.kickstart_coef)
        self._ks_decay = int(args.ppo.kickstart_decay_iters)
        self._iter_ks = (functools.partial(self.train_iteration, critic_only=False)
                         if (self._ks_warmup or self._ks_coef0) else None)
        self._iter_warmup = (functools.partial(self.train_iteration, critic_only=True)
                             if self._ks_warmup else None)

    def init_carry(self):
        """This rank's training carry: the env reset on all N envs, this
        rank's block kept (the shared context whole), its episode statistics
        and its key ``split(trainer.key, D)[rank]``."""
        (rgb, context), info = self.env.reset()
        block = functools.partial(shard_env_batch, self.mesh, axis_name=self.axis_name)
        context = dict(context)
        for k in ("per_env_context", "position", "time"):
            context[k] = block(context[k])
        obs = (block(rgb), context)
        dev = self.trainer.device
        done = torch.zeros(self.envs_per_shard, dtype=torch.bool, device=dev)
        stats = EpisodeStatistics.create(self.envs_per_shard, dev)
        key = rng.split(self.trainer.key, self.n_shards)[self.rank]
        return (self.trainer.agent_state, stats, obs, done, block(info), key)

    def train_iteration(self, agent_state, stats, obs, done, info, key, ks_coef=0.0,
                        critic_only=False):
        """One iteration on this rank's block: ``(agent_state, stats, obs,
        done, info, key, metrics)`` with the metrics averaged over the group
        (one all-reduce) as float32 device scalars."""
        *carry, metrics = self.trainer.train_iteration(agent_state, stats, obs, done, info,
                                                       key, ks_coef, critic_only)
        names = list(metrics)
        mean = group_mean([metrics[k].to(torch.float32) for k in names], self.group)
        self.metric_all_reduces += 1
        return (*carry, dict(zip(names, mean)))

    def train(self, num_iterations: int, log_fn=None):
        """The DP-PPO loop, one host sync an iteration; honours the
        kickstart-CE / critic-warmup schedule of ``PPOTrainer.train`` (CE at
        full strength through warmup, then a linear anneal to 0).  Run
        ``trainer.bc_pretrain`` before it to seed the clone.  ``global_step``
        counts the global batch.  Returns ``(agent_state, history)``."""
        carry = self.init_carry()
        history = []
        start = time.time()
        warmup = self._ks_warmup
        ks_decay = self._ks_decay or max(num_iterations - warmup, 1)
        for iteration in range(1, num_iterations + 1):
            if self._iter_ks is not None:
                frac = max(0.0, 1.0 - max(iteration - warmup - 1, 0) / ks_decay)
                fn = self._iter_warmup if iteration <= warmup else self._iter_ks
                *carry, metrics = fn(*carry, float(np.float32(self._ks_coef0 * frac)))
            else:
                *carry, metrics = self.train_iteration(*carry)
            values = torch.stack([v.to(torch.float64) for v in metrics.values()]).tolist()
            metrics = dict(zip(metrics, values))
            metrics["global_step"] = iteration * self.args.batch_size
            metrics["SPS"] = int(metrics["global_step"] / max(time.time() - start, 1e-9))
            history.append(metrics)
            if log_fn:
                log_fn(iteration, metrics)
        self.trainer.agent_state = carry[0]
        return carry[0], history
