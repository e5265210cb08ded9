"""PPO trainer — CleanRL-derived, on the device, for the Advanced env.

Counterpart of ``gymca_tpu/agents/ppo.py``: rollout -> GAE reverse pass ->
epoch/minibatch updates, Gumbel action sampling, per-head categorical
losses, episode statistics with a last-10 ring buffer and day/night
extension-accuracy accounting, the round-5 pipeline (BC warm-start, critic
warmup, annealed kickstart CE) and potential-based reward shaping.

As in the JAX package every function of the iteration is pure: the carry
``(agent_state, stats, obs, done, info, key)`` goes in and a new one comes
out, the inputs untouched, so one carry run twice gives the same result.
The key chain is JAX's (``gymca_torch.rng``): ``split(key, 4)`` for the
trainer, the networks' init and nothing else; a split per action head per
step; a split per epoch for the minibatch shuffle (``rng.permutation``).
From the same trainer key, weights and env state, the port takes the
JAX trainer's actions and shuffles.

What the port does differently:

* the rollout, GAE and update are Python loops of eager torch ops instead
  of one jitted program; an iteration makes no host synchronisation (no
  ``.item()``, boolean-mask indexing or host branch on device values) until
  :meth:`PPOTrainer.train` fetches its metrics, once per iteration, as the
  JAX trainer does (``ppo.py:881``);
* the Gumbel noise ``-log(-log(u))`` goes through ``rng.xla_log``, which
  rounds as XLA's CPU ``log`` does (torch's ``log`` differs in the last bit
  on about one draw in seven);
* divisions by constants are multiplies by the float32 reciprocal, as XLA
  folds them under ``jit``;
* weights are initialised from a ``torch.Generator`` seeded with the
  networks' keys, not with flax's draws (parity tests carry weights with
  ``gymca_torch.interop.ppo_params_from_numpy``);
* the JAX trainer's ``axis_name`` is ``process_group``: with a group, each
  minibatch's grads and five losses are averaged over its ranks by one
  all-reduce of a flat float32 buffer (:func:`group_mean`) before the
  optimizer step; ``gymca_torch.parallel.sharded.DataParallelPPO`` builds
  the trainer so;
* on the card the convs run at torch's default precision there (cuDNN may
  use TF32) and the dense layers in float32;
* the rollout, the update and the BC warm-start run under cuDNN's
  deterministic algorithms (:func:`cudnn_deterministic`), so that one carry
  run twice on the card gives the same result bit for bit, as the JAX
  trainer's pure iteration does (``tests/test_ppo.py:71``): at
  ``scripts/run``'s defaults with TF32 off, cuDNN's default algorithms
  did not repeat on an H100.
* on a CUDA device the policy call (:meth:`PPOTrainer.get_action_and_value`:
  torso, heads, the three Gumbel draws and their key splits, argmax and
  log-probs) is one replay of a CUDA graph of :meth:`PPOTrainer.
  _policy_eager`, captured at the first call of each input signature
  (device, grid shape and dtype, feature shape, compute dtype, cuDNN and
  matmul precision and algorithm flags; :class:`_Graph`).  The graph holds
  the kernels the eager call launches, so it gives the same bits; it spares
  the host the eager call's ~550 launches.  Each call copies the params,
  grid, features and key into the graph's inputs and clones its outputs,
  so a moved params dict is always seen.
* on a CUDA device the rest of a rollout step, its env half
  (:meth:`PPOTrainer._env_step`: ``stateless_step``, the episode
  statistics, ``conditional_reset``, the shaped reward and the storage
  row), is one replay of a second graph (:meth:`PPOTrainer._graphed_step`),
  captured at the first step of each input signature (device, path, shape
  and dtype of every carry leaf, the rollout's length, the env's CA route,
  the trainer's shaping, kickstart, feature and extension flags, cuDNN and
  matmul flags).  The carry stays in the graph's inputs through a rollout:
  each replay writes the next carry over them and the row into the (T, N,
  ...) storage among them, so a step copies in only the action, log-probs
  and value (memory the capture allocates holds nothing from one replay to
  the next: each replay may rewrite it).  The rollout copies the caller's
  carry in at its first step and hands back clones of the carry and
  storage at its last, or the caller's own tensors where the steps pass
  them through (the terrain, the shared context), so nothing it returns is
  a buffer a later replay overwrites.  The CPU runs the eager bodies.

Spans (``gymca_torch.utils.metrics.span``, off unless enabled) mark the
iteration's layers: ``rollout`` (:meth:`PPOTrainer.rollout`), ``policy``
(:meth:`PPOTrainer.get_action_and_value`: the features, then on the card
``policy_graph``, the copies in, the graph's replay and the clones out, or
on the CPU the eager body with its key chain's ``rng`` spans), on the card
``step_graph`` (a rollout step's env half: the copies in, the replay, and
at the last step the clones out), on the CPU the env's own spans under
``rollout``, ``gae`` (``_compute_gae``, the bootstrap value and the
recurrence), ``update`` (``_update_ppo``), ``loss_grad`` (each minibatch's
:func:`value_and_grad`) and ``optimizer`` (:meth:`PPOTrainer.
apply_gradients`).  A graph's spans are entered at its warm-up and capture
only.  Host-int counters on the trainer count the work, spans on or off:
``samples_collected`` (env samples, envs x rollout steps),
``samples_forward`` (samples through the networks without a gradient: the
policy's and GAE's bootstrap), ``samples_trained`` (samples through
forward and backward, minibatch size x minibatches),
``policy_graph_captures`` and ``policy_graph_replays`` (the policy's CUDA
graphs captured and replayed) and ``step_graph_captures`` and
``step_graph_replays`` (the env half's; all four 0 on the CPU).  Launch
counters such as ``rng.threefry_launch.launches`` and
``alexandridis_fused_step.launches`` count the host's launch calls: a
graph's kernels count at its warm-ups and capture, never at its replays.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.func import functional_call

from gymca_torch import rng
from gymca_torch.agents import optim
from gymca_torch.agents.args import Args
from gymca_torch.agents.networks import Actor, Critic, Network, param_dict
from gymca_torch.config import resolve_device
from gymca_torch.utils.metrics import span

__all__ = ["AgentState", "Storage", "EpisodeStatistics", "PPOTrainer", "gae",
           "value_and_grad", "run_rollout_loop", "load_actor", "fire_centroid",
           "policy_features", "greedy_fire_action", "group_mean", "cudnn_deterministic"]

RECENT = 10  # ring-buffer length (reference jax_ppo.py:488)


def _over(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c`` as XLA compiles it under ``jit``: a
    multiply by the float32 reciprocal."""
    return x * float(np.float32(1.0) / np.float32(c))


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms, autotuning off, inside the block;
    the caller's two flags are restored when it ends.  TF32 is left as the
    caller set it."""
    flags = torch.backends.cudnn
    saved = flags.deterministic, flags.benchmark
    flags.deterministic, flags.benchmark = True, False
    try:
        yield
    finally:
        flags.deterministic, flags.benchmark = saved


def group_mean(tensors, group):
    """The mean of each tensor over the ranks of ``group``, rounded as JAX's
    ``pmean`` rounds it under ``jit``: the sum, then a multiply by the
    float32 reciprocal of the group size.  One all-reduce of one flat
    float32 buffer carries every tensor.

    Under NCCL the sum goes as a PREMUL_SUM by 1.0, which adds the same
    bits: NCCL answers a plain in-place SUM over a group of one rank with
    no device work at all, and the card's world of one rank must still run
    NCCL's all-reduce.  Gloo has no premultiplied sum and sums plainly."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    op = (dist._make_nccl_premul_sum(1.0) if dist.get_backend(group) == "nccl"
          else dist.ReduceOp.SUM)
    dist.all_reduce(flat, op=op, group=group)
    flat = _over(flat, dist.get_world_size(group))
    # each back in its tensor's own strides: autograd hands some grads out
    # in another memory order, and a reduction over them (the global norm)
    # sums in memory order
    return [torch.empty_like(t).copy_(p.view(t.shape))
            for p, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


class _Replace:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class AgentState(_Replace):
    """flax's ``TrainState`` without the apply function: ``params``
    (``{"network_params", "actor_params", "critic_params"}``, each
    ``{name: tensor}``), the optimizer state and the update count."""

    params: Dict[str, Dict[str, torch.Tensor]]
    opt_state: optim.AdamState
    step: torch.Tensor


@dataclass
class Storage(_Replace):
    grid_obs: torch.Tensor
    position_obs: torch.Tensor
    actions: torch.Tensor
    logprobs: torch.Tensor
    dones: torch.Tensor
    values: torch.Tensor
    advantages: torch.Tensor
    returns: torch.Tensor
    rewards: torch.Tensor
    # demonstrator actions for the kickstart CE term (zeros when
    # kickstart_coef == 0; same (N, heads) shape as ``actions``)
    demo_actions: torch.Tensor

    @classmethod
    def stack(cls, rows: List["Storage"]) -> "Storage":
        return cls(**{f.name: torch.stack([getattr(r, f.name) for r in rows])
                      for f in dataclasses.fields(cls)})


@dataclass
class EpisodeStatistics(_Replace):
    episode_returns: torch.Tensor
    episode_lengths: torch.Tensor
    returned_episode_returns: torch.Tensor
    returned_episode_lengths: torch.Tensor
    amount_finished: torch.Tensor
    recent_returns: torch.Tensor
    recent_lengths: torch.Tensor
    recent_idx: torch.Tensor
    current_day_correct: torch.Tensor
    current_night_correct: torch.Tensor
    current_day_steps: torch.Tensor
    current_night_steps: torch.Tensor
    recent_day_correct: torch.Tensor
    recent_night_correct: torch.Tensor
    recent_day_steps: torch.Tensor
    recent_night_steps: torch.Tensor

    @classmethod
    def create(cls, num_envs: int, device=None) -> "EpisodeStatistics":
        dev = resolve_device(device)
        zf = lambda n: torch.zeros(n, dtype=torch.float32, device=dev)  # noqa: E731
        zi = lambda n: torch.zeros(n, dtype=torch.int32, device=dev)  # noqa: E731
        return cls(
            episode_returns=zf(num_envs),
            episode_lengths=zi(num_envs),
            returned_episode_returns=zf(num_envs),
            returned_episode_lengths=zi(num_envs),
            amount_finished=zi(()),
            recent_returns=zf(RECENT),
            recent_lengths=zi(RECENT),
            recent_idx=zi(()),
            current_day_correct=zi(num_envs),
            current_night_correct=zi(num_envs),
            current_day_steps=zi(num_envs),
            current_night_steps=zi(num_envs),
            recent_day_correct=zi(RECENT),
            recent_night_correct=zi(RECENT),
            recent_day_steps=zi(RECENT),
            recent_night_steps=zi(RECENT),
        )


def fire_centroid(tg: torch.Tensor, fire: int = 2):
    """Fire cell count and the fire centroid (row, col) of each env's true
    grid; the centroid of a fire-free env is (0, 0)."""
    on_fire = (tg == fire).to(torch.float32)
    h, w = tg.shape[-2], tg.shape[-1]
    tot = on_fire.sum((-2, -1))
    denom = torch.clamp(tot, min=1.0)
    rows = torch.arange(h, dtype=torch.float32, device=tg.device)[None, :, None]
    cols = torch.arange(w, dtype=torch.float32, device=tg.device)[None, None, :]
    return tot, (on_fire * rows).sum((-2, -1)) / denom, (on_fire * cols).sum((-2, -1)) / denom


def policy_features(context, nrows: int, ncols: int, position: bool, centroid: bool,
                    fire: int = 2):
    """Auxiliary policy/value input features, already normalized, (N, F)
    float32 (None with neither flag): ``position`` — the agent's (row/H,
    col/W); ``centroid`` — the agent->fire-centroid offset and a
    fire-present flag, from the TRUE grid."""
    pos = context["position"].to(torch.float32)
    feats = []
    if position:
        feats.append(torch.stack([_over(pos[:, 0], nrows), _over(pos[:, 1], ncols)], dim=-1))
    if centroid:
        tg = context["per_env_context"]["true_grid"]
        h, w = tg.shape[-2], tg.shape[-1]
        tot, cr, cc = fire_centroid(tg, fire)
        has_fire = (tot > 0).to(torch.float32)
        feats.append(torch.stack([_over(has_fire * (cr - pos[:, 0]), h),
                                  _over(has_fire * (cc - pos[:, 1]), w), has_fire], dim=-1))
    return torch.cat(feats, dim=-1) if feats else None


def greedy_fire_action(context, n_heads: int = 3, fire: int = 2) -> torch.Tensor:
    """The greedy-fire hand policy, (N, n_heads) int32: step toward the live
    fire's centroid, always shoot, extension heads 0."""
    _, cr, cc = fire_centroid(context["per_env_context"]["true_grid"], fire)
    pos = context["position"].to(torch.float32)
    dr = torch.sign(cr - pos[:, 0]).to(torch.int32)
    dc = torch.sign(cc - pos[:, 1]).to(torch.int32)
    move = (dr + 1) * 3 + (dc + 1)
    heads = [move, torch.ones_like(move)] + [torch.zeros_like(move)
                                             for _ in range(n_heads - 2)]
    return torch.stack(heads, dim=1).to(torch.int32)


def _ring_owners(mask, recent_idx):
    """The env each ring slot takes a value from (-1: the slot keeps its
    value) when the envs of ``mask`` finish: they take consecutive slots
    from ``recent_idx`` on.  When more than ``RECENT`` envs finish at once
    several share a slot, and the last of them (the highest env index) wins,
    as XLA's CPU scatter orders the JAX package's ``_ring_scatter``."""
    ranks = torch.cumsum(mask, 0) - 1
    slots = torch.where(mask, (recent_idx + ranks) % RECENT, RECENT)
    env = torch.arange(mask.shape[0], device=mask.device)
    owner = torch.full((RECENT + 1,), -1, dtype=torch.int64, device=mask.device)
    return owner.scatter_reduce(0, slots, env, "amax")[:RECENT]


def _ring_put(buffer, values, owners):
    picked = values[owners.clamp(min=0)].to(buffer.dtype)
    return torch.where(owners >= 0, picked, buffer)


def _log_softmax_at(lsm: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return lsm.gather(-1, idx.long()[:, None])[:, 0]


def value_and_grad(fn, params, *args):
    """``jax.value_and_grad(fn, has_aux=True)`` over a params tree:
    ``(loss, aux, grads)`` for ``fn(params, *args) -> (loss, aux)``, loss and
    aux detached, a zero gradient for each param the loss does not use."""
    leaves = optim.tree_leaves(params)
    live = [t.detach().requires_grad_() for t in leaves]
    with torch.enable_grad():
        loss, aux = fn(optim.tree_unflatten(params, live), *args)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    aux = tuple(a.detach() for a in aux) if isinstance(aux, tuple) else aux.detach()
    return loss.detach(), aux, optim.tree_unflatten(params, grads)


def gae(rewards, values, dones, next_value, next_done, gamma: float, lam: float):
    """Generalized advantage estimates (T, N) by the reverse recurrence of
    the JAX trainer's scan: ``dones[t]`` marks the obs of step t as the
    first of an episode, ``next_*`` the obs after the last step."""
    dones = torch.cat([dones, next_done[None].to(dones.dtype)], 0)[1:].to(torch.float32)
    values = torch.cat([values, next_value[None]], 0)
    adv = torch.zeros_like(next_value)
    out = []
    for t in reversed(range(rewards.shape[0])):
        nextnonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * values[t + 1] * nextnonterminal - values[t]
        adv = delta + gamma * lam * nextnonterminal * adv
        out.append(adv)
    return torch.stack(out[::-1])


def _children(tree):
    """A tree node's children as ``(key, child)`` pairs (dicts by sorted
    key, tuples and lists by position, dataclasses by field), or None for a
    leaf: a tensor, None or any other value."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return list(enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    return None


def _leaves(tree, path=()):
    """``[(path, leaf)]`` of a tree, in :func:`_children`'s order."""
    children = _children(tree)
    if children is None:
        return [(path, tree)]
    return [x for k, child in children for x in _leaves(child, path + (k,))]


def _rebuild(like, leaves):
    """A tree shaped as ``like`` whose leaves, in :func:`_leaves`' order, are
    taken from the iterator ``leaves``."""
    children = _children(like)
    if children is None:
        return next(leaves)
    built = {k: _rebuild(child, leaves) for k, child in children}
    if isinstance(like, dict):
        return {k: built[k] for k in like}
    if isinstance(like, (tuple, list)):
        return type(like)(built[i] for i in range(len(like)))
    return dataclasses.replace(like, **built)


def _tree_map(fn, tree):
    """``tree`` with ``fn`` applied to each tensor leaf."""
    return _rebuild(tree, iter([fn(x) if isinstance(x, torch.Tensor) else x
                                for _, x in _leaves(tree)]))


def _tensors(tree):
    """The tensor leaves of a tree, in :func:`_leaves`' order, without their
    paths: the per-call flattening of a graph's inputs."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for child in tree for x in _tensors(child)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree) for x in _tensors(getattr(tree, f.name))]
    return []


def _copy_pairs(dsts, srcs):
    """``dst.copy_(src)`` for each pair: one ``_foreach_copy_`` a dtype."""
    groups = {}
    for dst, src in zip(dsts, srcs):
        group = groups.setdefault(dst.dtype, ([], []))
        group[0].append(dst)
        group[1].append(src)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


def _copy_tree(dst, src):
    """Copy the tensors of the tree ``src`` into those of ``dst``, a tree of
    the same structure."""
    _copy_pairs(_tensors(dst), _tensors(src))


def _write_back(static, new):
    """Copy the tensors of the tree ``new`` into those of ``static`` (a tree
    of the same paths), and say, leaf by leaf, whether ``new`` held
    ``static``'s own tensor there (passed through, so left as it is).  A
    tensor of ``new`` sharing memory with one of ``static`` is cloned before
    any copy, so that no copy reads what another has written."""
    dst, src = _leaves(static), _leaves(new)
    if [p for p, _ in dst] != [p for p, _ in src]:
        raise ValueError("the step's next carry is not shaped as its carry")
    kept = tuple(s is d for (_, d), (_, s) in zip(dst, src))
    held = {d.untyped_storage().data_ptr() for _, d in dst if isinstance(d, torch.Tensor)}
    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in held else s)
             for ((_, d), (_, s)), k in zip(zip(dst, src), kept)
             if not k and isinstance(d, torch.Tensor)]
    _copy_pairs([d for d, _ in pairs], [s for _, s in pairs])
    return kept


class _Graph:
    """One CUDA graph of ``fn(*args)`` at the signature of the arguments it
    is built with (trees of dicts, tuples, lists and dataclasses whose
    tensors are the inputs): static copies of those arguments (``args``),
    ``WARMUP`` eager calls on them on a side stream, then the capture on
    them, whose outputs (``out``) each replay overwrites.  A call copies its
    arguments' tensors into the static copies (``inputs``, one
    ``_foreach_copy_`` a dtype), replays the graph and returns clones of the
    outputs; none of it waits for the device."""

    WARMUP = 3  # eager calls on a side stream before the capture, as torch's docs do

    def __init__(self, fn, *args):
        self.args = _tree_map(torch.clone, args)
        self.inputs = _tensors(self.args)
        dev = self.inputs[0].device
        with torch.cuda.device(dev):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(self.WARMUP):  # lazy set-up (handles, workspaces) off the capture
                    fn(*self.args)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            # thread-local: other threads' CUDA calls (NCCL's watchdog) go on
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self.out = fn(*self.args)

    def replay(self):
        self.graph.replay()

    def __call__(self, *args):
        _copy_pairs(self.inputs, _tensors(args))
        self.graph.replay()
        return _tree_map(torch.clone, self.out)


class PPOTrainer:
    """Owns the networks, the optimizer and the train iteration.

    ``env`` must expose the port's Advanced-env API: ``reset()``,
    ``stateless_step(action, obs, info)``, ``conditional_reset(step, action)``,
    ``total_action_space`` and ``extension_choices``, on ``device`` (the
    card unless the caller names another; without a CUDA device
    ``device=None`` raises).  ``key`` is ``(2,)`` key data (default
    ``rng.key(args.exp.seed)``).  ``process_group``, the JAX trainer's
    ``axis_name``: the ranks over which each minibatch's grads and losses
    are averaged (:func:`group_mean`, counted in ``grad_all_reduces``), as
    ``gymca_torch.parallel.sharded.DataParallelPPO`` trains; None trains
    alone.
    """

    def __init__(self, env, args: Args, key=None, device=None, process_group=None):
        self.device = dev = resolve_device(device)
        self.process_group = process_group
        self.grad_all_reduces = 0
        self.samples_collected = self.samples_forward = self.samples_trained = 0
        self.policy_graph_captures = self.policy_graph_replays = 0
        self.step_graph_captures = self.step_graph_replays = 0
        self._policy_graphs = {}  # input signature -> _Graph of _policy_eager
        self._step_graphs = {}  # input signature -> _Graph of _graphed_step
        if torch.device(env.device).type != dev.type:
            raise ValueError(f"the env runs on {env.device}, the trainer on {dev}")
        self.env = env
        self.args = args
        key = rng.key(args.exp.seed, device=dev) if key is None else key.to(dev)
        self.key, net_key, actor_key, critic_key = rng.split(key, 4).unbind(0)

        action_nvec = list(env.total_action_space.nvec)
        base_dims = action_nvec[:2]
        self.n_action_heads = len(action_nvec)
        # Extension day/night accuracy is only a measurement when the action
        # has extension heads AND the env actually consumes them (see the JAX
        # trainer's note on the reference's latent bug).
        self._track_extension_accuracy = self.n_action_heads > 2 and bool(
            getattr(env, "enable_extensions", True))

        self.position_features = bool(args.exp.position_features)
        self.centroid_features = bool(getattr(args.exp, "centroid_features", False))
        self._use_features = self.position_features or self.centroid_features
        self._shaping = (args.ppo.shape_tree_coef != 0.0 or args.ppo.shape_dist_coef != 0.0
                         or args.ppo.shape_douse_coef != 0.0)
        self._kickstart = args.ppo.kickstart_coef != 0.0
        n_feats = 2 * self.position_features + 3 * self.centroid_features

        def gen(k):
            words = [int(w) for w in k.cpu()]
            return torch.Generator().manual_seed((words[0] << 32) | words[1])

        dtype = torch.bfloat16 if args.exp.bf16_compute else torch.float32
        self.network = Network(env.nrows, env.ncols, compute_dtype=dtype,
                               generator=gen(net_key)).to(dev)
        self.actor = Actor(128 + n_feats, base_dims, tuple(env.extension_choices),
                           generator=gen(actor_key)).to(dev)
        self.critic = Critic(128 + n_feats, generator=gen(critic_key)).to(dev)
        for m in (self.network, self.actor, self.critic):
            m.requires_grad_(False)
        params = {"actor_params": param_dict(self.actor),
                  "critic_params": param_dict(self.critic),
                  "network_params": param_dict(self.network)}

        if args.ppo.anneal_lr:
            self._lr = optim.linear_schedule(
                args.ppo.learning_rate, args.ppo.num_minibatches * args.ppo.update_epochs,
                args.num_iterations)
        else:
            self._lr = args.ppo.learning_rate
        self.agent_state = AgentState(
            params=params, opt_state=optim.adam_init(params, args.ppo.learning_rate),
            step=torch.zeros((), dtype=torch.int32, device=dev))
        self.param_counts = {
            name: sum(t.numel() for t in params[f"{name}_params"].values())
            for name in ("network", "actor", "critic")}

    # ----------------------------------------------------------- policy fns

    def _policy_features(self, context):
        """Auxiliary policy/value input features (:func:`policy_features`),
        or None when no feature flag is on."""
        if not self._use_features:
            return None
        return policy_features(context, self.env.nrows, self.env.ncols,
                               self.position_features, self.centroid_features,
                               self.env._fire)

    def _torso(self, params, grid, feats):
        """CNN hidden, optionally augmented with the pre-computed policy
        features from :meth:`_policy_features`."""
        hidden = functional_call(self.network, params["network_params"], (grid,))
        if self._use_features:
            hidden = torch.cat([hidden, feats], dim=-1)
        return hidden

    def _actor_logits(self, params, hidden):
        return functional_call(self.actor, params["actor_params"], (hidden,))

    def _value(self, params, hidden):
        return functional_call(self.critic, params["critic_params"], (hidden,))[:, 0]

    @span("policy")
    def get_action_and_value(self, agent_state, obs, key):
        """Sample per-head actions via the Gumbel trick (jax_ppo.py:866-899):
        ``(actions, logprobs, value, next key)``.  :meth:`_policy_eager` on
        the CPU; on a CUDA device one replay of its CUDA graph for these
        inputs' signature (:meth:`_policy_signature`), captured at the
        signature's first call."""
        grid_obs, context = obs
        params = agent_state.params
        self.samples_forward += grid_obs.shape[0]
        feats = self._policy_features(context)
        if grid_obs.device.type != "cuda":
            return self._policy_eager(params, grid_obs, feats, key)
        signature = self._policy_signature(grid_obs, feats)
        graph = self._policy_graphs.get(signature)
        if graph is None:
            graph = _Graph(self._policy_eager, params, grid_obs, feats, key)
            self._policy_graphs[signature] = graph
            self.policy_graph_captures += 1
        self.policy_graph_replays += 1
        with span("policy_graph"):
            return graph(params, grid_obs, feats, key)

    def _policy_signature(self, grid, feats):
        """What decides the kernels a policy call launches: the device, the
        grid's shape and dtype, the features' shape, the compute dtype and
        the precision and algorithm flags of cuDNN and matmuls."""
        flags = torch.backends.cudnn
        return (grid.device, tuple(grid.shape), grid.dtype,
                None if feats is None else (tuple(feats.shape), feats.dtype),
                self.network.compute_dtype, flags.allow_tf32, flags.deterministic,
                flags.benchmark, torch.backends.cuda.matmul.allow_tf32)

    def _policy_eager(self, params, grid, feats, key):
        """The policy call in eager ops: the spec, and the body of its CUDA
        graph.  A function of its inputs alone."""
        with torch.no_grad():
            hidden = self._torso(params, grid, feats)
            actions, logprobs = [], []
            for logits in self._actor_logits(params, hidden):
                pair = rng.split(key)
                key, subkey = pair[0], pair[1]
                u = rng.uniform(subkey, logits.shape)
                action = torch.argmax(logits - rng.xla_log(-rng.xla_log(u)), dim=-1)
                actions.append(action)
                logprobs.append(_log_softmax_at(torch.log_softmax(logits, -1), action))
            value = self._value(params, hidden)
        return (torch.stack(actions, dim=1).to(torch.int32), torch.stack(logprobs, dim=1),
                value, key)

    def get_action_and_value2(self, params, x, action, demo_action=None):
        """Logprob/entropy/value of given actions (jax_ppo.py:901-930).

        When ``demo_action`` is given, additionally returns the summed
        log-probability of the demonstrator's move/shoot actions."""
        grid, position = x
        hidden = self._torso(params, grid, position)
        logprobs, entropies = [], []
        demo_logp = 0.0
        for i, logit in enumerate(self._actor_logits(params, hidden)):
            lsm = torch.log_softmax(logit, -1)
            logprobs.append(_log_softmax_at(lsm, action[:, i]))
            if demo_action is not None and i < 2:
                demo_logp = demo_logp + _log_softmax_at(lsm, demo_action[:, i])
            logits = logit - torch.logsumexp(logit, -1, keepdim=True)
            logits = torch.clamp(logits, min=torch.finfo(logits.dtype).min)
            entropies.append(-(logits * torch.softmax(logits, -1)).sum(-1))
        logprobs = torch.stack(logprobs, dim=1)
        entropies = torch.stack(entropies, dim=1)
        value = self._value(params, hidden)
        if demo_action is not None:
            return logprobs, entropies, value, demo_logp
        return logprobs, entropies, value

    # -------------------------------------------------------------- episode stats

    def _update_episode_stats(self, stats, action, obs, next_info):
        is_night = obs[1]["per_env_context"]["is_night"]
        # correct extension: see-invisible-fires (2) by day, unblur (1) by night
        if self._track_extension_accuracy:
            ext_action = action[:, -1]
            day_correct = ((1 - is_night) * (ext_action == 2)).to(torch.int32)
            night_correct = (is_night * (ext_action == 1)).to(torch.int32)
        else:
            day_correct = torch.zeros_like(is_night, dtype=torch.int32)
            night_correct = torch.zeros_like(is_night, dtype=torch.int32)

        new_return = stats.episode_returns + next_info["reward"]
        new_length = stats.episode_lengths + 1
        finished = next_info["terminated"] | next_info["TimeLimit.truncated"]
        keep = (~finished).to(torch.int32)

        cur_day_correct = stats.current_day_correct + day_correct
        cur_night_correct = stats.current_night_correct + night_correct
        cur_day_steps = stats.current_day_steps + (1 - is_night).to(torch.int32)
        cur_night_steps = stats.current_night_steps + is_night.to(torch.int32)

        idx = stats.recent_idx
        owners = _ring_owners(finished, idx)

        def rs(buffer, values):
            return _ring_put(buffer, values, owners)

        return stats.replace(
            recent_returns=rs(stats.recent_returns, new_return),
            recent_lengths=rs(stats.recent_lengths, new_length),
            recent_day_correct=rs(stats.recent_day_correct, cur_day_correct),
            recent_night_correct=rs(stats.recent_night_correct, cur_night_correct),
            recent_day_steps=rs(stats.recent_day_steps, cur_day_steps),
            recent_night_steps=rs(stats.recent_night_steps, cur_night_steps),
            recent_idx=((idx + finished.sum()) % RECENT).to(torch.int32),
            amount_finished=(stats.amount_finished
                             + next_info["terminated"].sum()).to(torch.int32),
            episode_returns=new_return * keep,
            episode_lengths=(new_length * keep).to(torch.int32),
            returned_episode_returns=torch.where(finished, new_return,
                                                 stats.returned_episode_returns),
            returned_episode_lengths=torch.where(finished, new_length,
                                                 stats.returned_episode_lengths
                                                 ).to(torch.int32),
            current_day_correct=cur_day_correct * keep,
            current_night_correct=cur_night_correct * keep,
            current_day_steps=cur_day_steps * keep,
            current_night_steps=cur_night_steps * keep,
        )

    # ----------------------------------------------------------------- rollout

    def _potential(self, context):
        """Shaping potential phi(s) per env (see PPOArgs.shape_*_coef):
        tree_coef * trees_fraction - dist_coef * dist(agent, fire
        centroid)/diag + douse_coef * |doused cells near fire| / 100."""
        pe = context["per_env_context"]
        tg = pe["true_grid"]
        h, w = tg.shape[-2], tg.shape[-1]
        phi = torch.zeros(tg.shape[0], dtype=torch.float32, device=tg.device)
        tree_c = self.args.ppo.shape_tree_coef
        dist_c = self.args.ppo.shape_dist_coef
        if tree_c != 0.0:
            trees = (tg == self.env._tree).sum((-2, -1))
            phi = phi + _over(tree_c * trees.to(torch.float32), h * w)
        if dist_c != 0.0:
            tot, cr, cc = fire_centroid(tg, self.env._fire)
            pos = context["position"].to(torch.float32)
            sq = (cr - pos[:, 0]) ** 2 + (cc - pos[:, 1]) ** 2
            # torch's float32 sqrt on the CPU is not correctly rounded; XLA's is
            dist = _over(torch.sqrt(sq.double()).float(), math.sqrt(h * h + w * w))
            phi = phi - dist_c * torch.where(tot > 0, dist, 0.0)
        douse_c = self.args.ppo.shape_douse_coef
        if douse_c != 0.0:
            # doused cells whose 5x5 suppression box contains live fire:
            # fire dilated by Chebyshev radius 2, intersected with the dousing
            fire = (tg == self.env._fire).to(torch.float32)
            near_fire = F.max_pool2d(fire[:, None], 5, stride=1, padding=2)[:, 0]
            doused = (pe["dousing_count"] > 0).to(torch.float32)
            useful = (doused * (near_fire > 0)).sum((-2, -1))
            phi = phi + _over(douse_c * useful, 100.0)
        return phi

    def _step_once(self, carry):
        agent_state, stats, obs, done, info, key = carry
        action, logprob, value, key = self.get_action_and_value(agent_state, obs, key)
        self.samples_collected += action.shape[0]
        stats, next_obs, next_done, next_info, row = self._env_step(action, logprob, value,
                                                                    stats, obs, done, info)
        return (agent_state, stats, next_obs, next_done, next_info, key), row

    def _env_step(self, action, logprob, value, stats, obs, done, info):
        """A rollout step's env half in eager ops: the env's step, the
        episode statistics, the auto-reset, the shaped reward and the
        storage row; ``(stats, next obs, next done, next info, row)``.  A
        function of its inputs alone: the CPU's body, and the body of the
        step's CUDA graph (:meth:`_graphed_step`)."""
        step_tuple = self.env.stateless_step(action, obs, info)
        stats = self._update_episode_stats(stats, action, obs, step_tuple[4])
        next_obs, reward, next_done, _, next_info = self.env.conditional_reset(step_tuple,
                                                                               action)
        train_reward = reward
        if self._shaping:
            # potential-based shaping r' = r + gamma*phi(s') - phi(s), phi := 0
            # at terminal states — the learning signal only; the episode
            # statistics above use the true reward.
            phi_s = self._potential(obs[1])
            phi_sp = torch.where(step_tuple[2], 0.0, self._potential(step_tuple[0][1]))
            train_reward = reward + self.args.ppo.gamma * phi_sp - phi_s
        row = Storage(
            grid_obs=obs[0],
            position_obs=(self._policy_features(obs[1]) if self._use_features
                          else obs[1]["position"]),
            actions=action,
            logprobs=logprob,
            dones=done,
            values=value,
            rewards=train_reward,
            returns=torch.zeros_like(reward),
            advantages=torch.zeros_like(reward),
            demo_actions=(self._greedy_demo_action(obs[1]) if self._kickstart
                          else torch.zeros_like(action)),
        )
        return stats, next_obs, next_done, next_info, row

    def _graphed_step(self, i, action, logprob, value, carry, storage):
        """The step graph's body: :meth:`_env_step` on ``carry`` ``(stats,
        obs, done, info)``, its row written at step ``i % num_ppo_steps`` of
        ``storage``, the next carry written over ``carry`` and ``i``
        advanced; which carry leaves the step passed through.  What a replay
        must leave for the next (the carry, the storage, ``i``) is in its
        inputs: memory the capture allocates may be rewritten by any
        replay."""
        *new, row = self._env_step(action, logprob, value, *carry)
        at = i % self.args.exp.num_ppo_steps
        for (_, rows), (_, x) in zip(_leaves(storage), _leaves(row)):
            rows.index_copy_(0, at, x[None])
        kept = _write_back(carry, tuple(new))
        i.add_(1)
        return kept

    def _step_signature(self, args):
        """What decides the kernels a step graph launches: the device, path,
        shape and dtype of every input, the rollout's length, the env's CA
        route, the trainer's shaping, kickstart, feature and extension
        flags and the shaping's constants, and the precision and algorithm
        flags of cuDNN and matmuls."""
        ppo, flags = self.args.ppo, torch.backends.cudnn
        inputs = tuple((p, x.device, tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor)
                       else (p, x) for p, x in _leaves(args))
        return (inputs, self.args.exp.num_ppo_steps, self.env.use_fused_ca,
                self.env.ca_repeat_mode, self._shaping, self._kickstart, self.position_features,
                self.centroid_features, self._track_extension_accuracy,
                (ppo.gamma, ppo.shape_tree_coef, ppo.shape_dist_coef, ppo.shape_douse_coef),
                flags.allow_tf32, flags.deterministic, flags.benchmark,
                torch.backends.cuda.matmul.allow_tf32)

    def _rollout_graphed(self, agent_state, carry, key):
        """:meth:`rollout` on a CUDA device: each step one replay of the
        policy's graph, then one of the step's (:meth:`_graphed_step`,
        captured at an input signature's first step).  The caller's carry
        ``(stats, obs, done, info)`` is copied into the step graph's inputs
        at the first step, where it stays through the rollout; the last step
        hands back clones of the graph's carry and storage, or the caller's
        own tensors where the steps passed them through."""
        steps = self.args.exp.num_ppo_steps
        obs, graph = carry[1], None
        for t in range(steps):
            action, logprob, value, key = self.get_action_and_value(agent_state, obs, key)
            self.samples_collected += action.shape[0]
            with span("step_graph"):
                if graph is None:
                    i = torch.zeros(1, dtype=torch.int64, device=action.device)
                    args = (i, action, logprob, value, carry)
                    signature = self._step_signature(args)
                    graph = self._step_graphs.get(signature)
                    if graph is None:
                        # an eager step gives the row's shapes: the graph's
                        # storage, (T, N, ...), is one of its inputs
                        row = self._env_step(action, logprob, value, *carry)[-1]
                        rows = _tree_map(lambda x: x[None].expand((steps,) + x.shape), row)
                        graph = _Graph(self._graphed_step, *args, rows)
                        self._step_graphs[signature] = graph
                        self.step_graph_captures += 1
                    _copy_tree(graph.args[:5], args)
                    obs = graph.args[4][1]
                else:
                    _copy_tree(graph.args[1:4], (action, logprob, value))
                graph.replay()
                self.step_graph_replays += 1
                if t == steps - 1:
                    out = [x if k else s.clone() for (_, x), (_, s), k
                           in zip(_leaves(carry), _leaves(graph.args[4]), graph.out)]
                    carry = _rebuild(carry, iter(out))
                    storage = _tree_map(torch.clone, graph.args[5])
        stats, obs, done, info = carry
        return (agent_state, stats, obs, done, info, key), storage

    # -------------------------------------------------------------------- GAE

    @span("gae")
    def _compute_gae(self, agent_state, next_obs, next_done, storage):
        params = agent_state.params
        self.samples_forward += next_obs[0].shape[0]
        with torch.no_grad():
            next_value = self._value(params, self._torso(params, next_obs[0],
                                                         self._policy_features(next_obs[1])))
        advantages = gae(storage.rewards, storage.values, storage.dones, next_value, next_done,
                         self.args.ppo.gamma, self.args.ppo.gae_lambda)
        return storage.replace(advantages=advantages, returns=advantages + storage.values)

    # ------------------------------------------------------------------- update

    def _ppo_loss(self, params, x, a, logp, mb_advantages, mb_returns, mb_values,
                  demo_a=None, ks_coef=0.0):
        """``(loss, (pg_loss, v_loss, entropy_loss, approx_kl))``;
        ``approx_kl`` carries no gradient."""
        ppo = self.args.ppo
        if self._kickstart:
            newlogprob, entropy, newvalue, demo_logp = self.get_action_and_value2(
                params, x, a, demo_a)
        else:
            newlogprob, entropy, newvalue = self.get_action_and_value2(params, x, a)
        logratio = newlogprob - logp
        ratio = torch.exp(logratio)
        approx_kl = ((ratio - 1) - logratio).mean().detach()

        if ppo.norm_adv:
            mb_advantages = (mb_advantages - mb_advantages.mean()) / (
                mb_advantages.std(correction=0) + 1e-8)

        pg_loss1 = -mb_advantages * ratio
        pg_loss2 = -mb_advantages * torch.clamp(ratio, 1 - ppo.clip_coef, 1 + ppo.clip_coef)
        pg_loss = torch.maximum(pg_loss1, pg_loss2).mean()

        if ppo.clip_vloss:
            v_loss_unclipped = 0.5 * ((newvalue - mb_returns) ** 2).mean()
            v_clipped = mb_values + torch.clamp(newvalue - mb_values, -ppo.clip_coef,
                                                ppo.clip_coef)
            v_loss_clipped = (v_clipped - mb_returns) ** 2
            v_loss = 0.5 * torch.maximum(v_loss_unclipped, v_loss_clipped).mean()
        else:
            v_loss = 0.5 * ((newvalue - mb_returns) ** 2).mean()

        entropy_loss = entropy.mean()
        loss = pg_loss - ppo.ent_coef * entropy_loss + v_loss * ppo.vf_coef
        if self._kickstart:
            # annealed CE toward the demonstrator on the move/shoot heads
            loss = loss - ks_coef * demo_logp.mean()
        return loss, (pg_loss, v_loss, entropy_loss, approx_kl)

    @span("optimizer")
    def apply_gradients(self, agent_state, grads):
        """One optimizer step (flax ``TrainState.apply_gradients``)."""
        params, opt_state = optim.adam_update(
            grads, agent_state.opt_state, agent_state.params, self._lr, eps=1e-5,
            max_grad_norm=self.args.ppo.max_grad_norm)
        return agent_state.replace(params=params, opt_state=opt_state,
                                   step=agent_state.step + 1)

    @span("update")
    def _update_ppo(self, agent_state, storage, key, ks_coef=0.0, critic_only=False):
        ppo = self.args.ppo
        flat = storage.replace(**{f.name: getattr(storage, f.name).flatten(0, 1)
                                  for f in dataclasses.fields(storage)})
        batch = flat.rewards.shape[0]
        metrics = None
        for _ in range(ppo.update_epochs):
            pair = rng.split(key)
            key, subkey = pair[0], pair[1]
            order = rng.permutation(subkey, batch).reshape(ppo.num_minibatches, -1)
            for idx in order:
                mb = flat.replace(**{f.name: getattr(flat, f.name)[idx]
                                     for f in dataclasses.fields(flat)})
                # advantages broadcast across the action heads (jax_ppo.py:1066-1072)
                advantages = mb.advantages[:, None].expand(-1, self.n_action_heads)
                self.samples_trained += idx.shape[0]
                with span("loss_grad"):
                    loss, aux, grads = value_and_grad(
                        self._ppo_loss, agent_state.params, (mb.grid_obs, mb.position_obs),
                        mb.actions, mb.logprobs, advantages, mb.returns, mb.values,
                        mb.demo_actions, ks_coef)
                if critic_only:
                    # critic-warmup phase: zero torso and actor grads go through
                    # the same chain, so the moments and the count advance
                    grads = {g: (v if g == "critic_params"
                                 else {k: torch.zeros_like(t) for k, t in v.items()})
                             for g, v in grads.items()}
                metrics = (loss,) + aux
                if self.process_group is not None:
                    # data-parallel mean over the group (gymca_tpu/agents/ppo.py:614-620)
                    leaves = optim.tree_leaves(grads)
                    mean = group_mean(leaves + list(metrics), self.process_group)
                    self.grad_all_reduces += 1
                    grads = optim.tree_unflatten(grads, mean[:len(leaves)])
                    metrics = tuple(mean[len(leaves):])
                agent_state = self.apply_gradients(agent_state, grads)
        names = ("loss", "policy_loss", "value_loss", "entropy_loss", "approx_kl")
        return agent_state, dict(zip(names, metrics)), key

    # --------------------------------------------------------------- iteration

    @span("rollout")
    def rollout(self, agent_state, stats, obs, done, info, key):
        """``num_ppo_steps`` env steps under the current policy:
        ``(carry, storage)`` with storage leaves (T, N, ...).  On a CUDA
        device each step is two graph replays (:meth:`_rollout_graphed`);
        on the CPU, :meth:`_step_once`."""
        carry, rows = (agent_state, stats, obs, done, info, key), []
        with cudnn_deterministic():
            if obs[0].device.type == "cuda":
                return self._rollout_graphed(agent_state, (stats, obs, done, info), key)
            for _ in range(self.args.exp.num_ppo_steps):
                carry, row = self._step_once(carry)
                rows.append(row)
        return carry, Storage.stack(rows)

    def learn(self, agent_state, next_obs, next_done, storage, key, ks_coef=0.0,
              critic_only=False):
        """GAE over a rollout's ``storage``, then the epochs of minibatch
        updates: ``(agent_state, losses, key, storage with advantages)``."""
        with cudnn_deterministic():
            storage = self._compute_gae(agent_state, next_obs, next_done, storage)
            agent_state, losses, key = self._update_ppo(agent_state, storage, key, ks_coef,
                                                        critic_only)
        return agent_state, losses, key, storage

    def train_iteration(self, agent_state, stats, obs, done, info, key, ks_coef=0.0,
                         critic_only=False):
        """rollout -> GAE -> update.  ``ks_coef`` anneals the kickstart CE;
        ``critic_only`` freezes torso+actor during the critic-warmup phase.
        Returns ``(agent_state, stats, obs, done, info, key, metrics)`` with
        metrics as device scalars."""
        (agent_state, stats, next_obs, next_done, next_info, key), storage = self.rollout(
            agent_state, stats, obs, done, info, key)
        agent_state, metrics, key, storage = self.learn(agent_state, next_obs, next_done,
                                                        storage, key, ks_coef, critic_only)
        metrics["episodic_return"] = stats.returned_episode_returns.mean()
        metrics["episodic_length"] = stats.returned_episode_lengths.to(torch.float32).mean()
        metrics["games_finished"] = stats.amount_finished
        metrics["recent_return"] = stats.recent_returns.mean()
        metrics["recent_length"] = stats.recent_lengths.to(torch.float32).mean()
        if self._track_extension_accuracy:
            metrics["day_accuracy"] = (stats.recent_day_correct.sum()
                                       / torch.clamp(stats.recent_day_steps.sum(), min=1))
            metrics["night_accuracy"] = (stats.recent_night_correct.sum()
                                         / torch.clamp(stats.recent_night_steps.sum(), min=1))
        # extensions inert -> the keys are absent rather than a fake 0%
        metrics["mean_reward"] = storage.rewards.mean()
        return agent_state, stats, next_obs, next_done, next_info, key, metrics

    # ------------------------------------------------------------ BC warm-start

    def _greedy_demo_action(self, context):
        """The greedy-fire hand policy as a demonstrator
        (:func:`greedy_fire_action`)."""
        return greedy_fire_action(context, self.n_action_heads, self.env._fire)

    def bc_pretrain(self, num_iterations: int, learning_rate: float = 2.5e-4,
                    log_fn: Optional[Callable[[int, dict], None]] = None):
        """Behavior-clone the torso+actor onto the greedy-fire demonstrator
        before PPO: each iteration rolls the demonstrator through the live
        env (num_ppo_steps x num_envs samples) and takes one epoch of
        minibatch steps of a plain Adam (eps 1e-8, no clipping).  Cross-
        entropy on the move/shoot heads only; the critic params and the PPO
        optimizer state are untouched."""
        env, nmb = self.env, self.args.ppo.num_minibatches

        def bc_loss(params, grids, feats, actions):
            logits_set = self._actor_logits(params, self._torso(params, grids, feats))
            ce, match = 0.0, 0.0
            for i, logit in enumerate(logits_set[:2]):
                ce = ce - _log_softmax_at(torch.log_softmax(logit, -1), actions[:, i]).mean()
                match = match + (torch.argmax(logit, -1) == actions[:, i]).float().mean()
            return ce, match / 2.0

        with cudnn_deterministic():
            obs, info = env.reset()
            params = self.agent_state.params
            opt_state = optim.adam_init(params, learning_rate)
            last = {}
            for it in range(1, num_iterations + 1):
                grids, feats, actions = [], [], []
                with torch.no_grad():
                    for _ in range(self.args.exp.num_ppo_steps):
                        action = self._greedy_demo_action(obs[1])
                        grids.append(obs[0])
                        feats.append(self._policy_features(obs[1]) if self._use_features
                                     else obs[1]["position"])
                        actions.append(action)
                        obs, _, _, _, info = env.conditional_reset(
                            env.stateless_step(action, obs, info), action)
                batch = [torch.stack(x).flatten(0, 1) for x in (grids, feats, actions)]
                losses, matches = [], []
                for mb in zip(*(x.reshape((nmb, -1) + x.shape[1:]) for x in batch)):
                    loss, match, grads = value_and_grad(bc_loss, params, *mb)
                    params, opt_state = optim.adam_update(grads, opt_state, params, learning_rate,
                                                          eps=1e-8)
                    losses.append(loss)
                    matches.append(match)
                loss, match = torch.stack([torch.stack(losses).mean(),
                                           torch.stack(matches).mean()]).tolist()
                last = {"bc_loss": loss, "bc_match": match}
                if log_fn is not None:
                    log_fn(it, last)
        self.agent_state = self.agent_state.replace(params=params)
        return last

    # --------------------------------------------------------------------- train

    def render_rollout(self, agent_state, num_steps: int = 64, env_idx: int = 0):
        """Roll the greedy (argmax) policy and capture the RGB observation of
        one env: (num_steps, H, W, 3) uint8 frames on the host."""
        obs, info = self.env.reset()
        frames = []
        with torch.no_grad():
            for _ in range(num_steps):
                logits = self._actor_logits(agent_state.params, self._torso(
                    agent_state.params, obs[0], self._policy_features(obs[1])))
                action = torch.stack([lg.argmax(-1) for lg in logits], 1).to(torch.int32)
                obs, _, _, _, info = self.env.conditional_reset(
                    self.env.stateless_step(action, obs, info), action)
                frames.append(obs[0][env_idx].to(torch.uint8))
        return torch.stack(frames).cpu().numpy()

    def train(self, num_iterations: Optional[int] = None,
              log_fn: Optional[Callable[[int, dict], None]] = None, checkpoint_manager=None,
              video_every: int = 0, video_fn: Optional[Callable[[int, np.ndarray], None]] = None):
        """The loop over iterations, one host sync each.  Returns
        (agent_state, history list)."""
        args = self.args
        num_iterations = num_iterations or args.num_iterations
        obs, info = self.env.reset()
        done = torch.zeros(args.env.num_envs, dtype=torch.bool, device=self.device)
        stats = EpisodeStatistics.create(args.env.num_envs, self.device)
        agent_state, key = self.agent_state, self.key
        history = []
        start = time.time()
        warmup = int(getattr(args.exp, "critic_warmup_iters", 0))
        ks_coef0 = float(args.ppo.kickstart_coef)
        ks_decay = int(args.ppo.kickstart_decay_iters) or max(num_iterations - warmup, 1)
        for iteration in range(1, num_iterations + 1):
            # kickstart CE holds at full strength through warmup, then anneals
            # linearly to 0 over ks_decay PPO iterations
            frac = max(0.0, 1.0 - max(iteration - warmup - 1, 0) / ks_decay)
            agent_state, stats, obs, done, info, key, metrics = self.train_iteration(
                agent_state, stats, obs, done, info, key,
                float(np.float32(ks_coef0 * frac)), critic_only=iteration <= warmup)
            # single host sync per iteration
            values = torch.stack([v.to(torch.float64) for v in metrics.values()]).tolist()
            metrics = dict(zip(metrics, values))
            global_step = iteration * args.batch_size
            metrics["global_step"] = global_step
            metrics["SPS"] = int(global_step / max(time.time() - start, 1e-9))
            history.append(metrics)
            if log_fn is not None:
                log_fn(iteration, metrics)
            if checkpoint_manager is not None and iteration % args.exp.checkpoint_every == 0:
                checkpoint_manager.save_state(iteration, agent_state, key)
            if video_every and video_fn and iteration % video_every == 0:
                video_fn(iteration, self.render_rollout(agent_state))
        self.agent_state, self.key = agent_state, key
        return agent_state, history


def run_rollout_loop(env, args: Args, key=None, log_fn=None, video_every=0, video_fn=None,
                     device=None):
    """Train PPO on ``env`` (counterpart of reference jax_ppo.py:419-1530)."""
    trainer = PPOTrainer(env, args, key, device=device)
    if getattr(args.exp, "bc_iters", 0):
        trainer.bc_pretrain(args.exp.bc_iters)
    ckpt = None
    if args.exp.checkpoint_dir:
        from gymca_torch.agents.checkpoint import CheckpointManager

        ckpt = CheckpointManager(args.exp.checkpoint_dir)
    agent_state, history = trainer.train(log_fn=log_fn or _default_log,
                                         checkpoint_manager=ckpt, video_every=video_every,
                                         video_fn=video_fn)
    return trainer, agent_state, history


def _default_log(iteration, metrics, every=1):
    """Print an iteration's metrics, for the first iteration and every
    ``every``-th one."""
    if iteration % every and iteration != 1:
        return
    print(f"iter {iteration}: SPS={metrics['SPS']} "
          f"return={metrics['episodic_return']:.3f} "
          f"loss={metrics['loss']:.4f} kl={metrics['approx_kl']:.4f}", flush=True)


def load_actor(params_path: str, env, args: Optional[Args] = None, device=None):
    """Restore the latest checkpoint and return a greedy policy
    ``get_action(obs_grid, context=None) -> (N, heads) int32``.

    ``args`` must carry the same model hyperparameters (conv_count, ...)
    the checkpoint was trained with; defaults otherwise."""
    from gymca_torch.agents.checkpoint import CheckpointManager

    args = args or Args()
    args.env.num_envs = env.num_envs
    trainer = PPOTrainer(env, args, device=device)
    agent_state, _ = CheckpointManager(params_path).restore_state(trainer.agent_state,
                                                                  trainer.key)

    def get_action(obs_grid, context=None):
        """Greedy action.  ``context`` (the obs[1] dict) is required iff the
        checkpoint was trained with position/centroid features."""
        if trainer._use_features and context is None:
            raise ValueError("this checkpoint was trained with policy features "
                             "(position/centroid); pass obs[1] as the second argument")
        feats = trainer._policy_features(context) if context is not None else None
        with torch.no_grad():
            hidden = trainer._torso(agent_state.params, obs_grid, feats)
            logits = trainer._actor_logits(agent_state.params, hidden)
        return torch.stack([lg.argmax(-1) for lg in logits], dim=1).to(torch.int32)

    return get_action
