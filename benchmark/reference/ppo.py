"""Plain reference of one PPO iteration of the IMPALA-CNN agent on the
Advanced env, and the check that holds the program's iteration to it.

Plain ``torch`` in float32 with TF32 off for matrix products and
convolutions (:func:`exact_float32`); it imports nothing of the program.
What it computes, as the configuration states it:

* the network (IMPALA's "deep" torso as CleanRL's ``ppo_procgen`` builds
  it, at the widths of gym-cellular-automata's ``jax_ppo.py``): the RGB
  observation / 255, a 5x5 stride-2 VALID conv, then ConvSequences of a
  3x3 SAME conv, a 3x3 stride-2 SAME max pool (flax pads low ``total // 2``
  with -inf) and two residual blocks ``x + conv(relu(conv(relu(x))))``;
  relu, flatten in NHWC order, a dense layer, relu; the actor's and the
  critic's two dense layers with relus, one categorical head per action
  dimension, one value.  Biases are added after each conv, as flax does;
* the log-probability of the taken action of each head (log-softmax), the
  entropies and the value;
* the PPO loss: ratio ``exp(new - old)`` per head, the advantages
  normalised and broadcast over the heads, the clipped policy loss, the
  clipped value loss, the entropy bonus, ``approx_kl``; its gradients by
  autograd;
* GAE by the reverse recurrence;
* ``optax.clip_by_global_norm`` then Adam (``scale_by_adam``, eps outside
  the square root, bias correction by the count after the update) at the
  rate ``lr (1 - (count // updates_per_iteration) / iterations)`` of the
  count before it;
* for the env, :func:`benchmark.reference.advanced.step` from the checked
  iteration's input state under the program's actions.

The check also holds the update's bookkeeping exactly, with no arithmetic:
the optimizer steps follow one another from the iteration's input params
and Adam state to its output, and each epoch's minibatches are the
rollout's samples under a permutation of all of them.

Departures from the published descriptions, each the upstream's own:

* advantages are normalised with the population standard deviation
  (``jnp.std``; CleanRL's torch ``std`` is the sample one);
* the clipped value loss is upstream ``jax_ppo.py``'s: its unclipped term
  is already the batch's half mean when the maximum is taken;
* the env's ``conditional_reset`` returns the reward of the merged grid and
  clears the terminated flags, so the trainer's dones are never set;
* the action has a third head, the extension combinations (3 logits),
  inert with extensions off.

``low=True`` computes every float in bfloat16 (the params, moments and
gradients kept as float32 tensors of bfloat16 values): with the env's
``low`` step it is the control, put in the program's place by
:func:`control_record`, that a check must read not correct.
"""

from __future__ import annotations

import contextlib
import math
import sys

import torch
import torch.nn.functional as F

from benchmark.reference import advanced as A
from benchmark.reference.compare import values_wrong

LOSSES = ("loss", "policy_loss", "value_loss", "entropy_loss", "approx_kl")
ENV_LEAVES = A._ALL
BLOCK = 128  # samples a forward pass of the check holds at once


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and convolutions inside the block; the
    caller's flags restored after it."""
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, s in zip(flags, saved):
            f.allow_tf32 = s


# --- the network -------------------------------------------------------------------------


def _conv(p, name, x, stride=1, padding=0):
    w, b = p[name + ".weight"], p[name + ".bias"]
    return F.conv2d(x, w.to(x.dtype), None, stride, padding) + b.to(x.dtype)[:, None, None]


def _dense(p, name, x):
    return x @ p[name + ".weight"].to(x.dtype).T + p[name + ".bias"].to(x.dtype)


def _pool_same(x):
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=-math.inf), 3, 2)


def torso(cfg: dict, p: dict, grid, dt=torch.float32):
    net = cfg["network"]
    x = (grid.to(torch.float32) / 255.0).to(dt).permute(0, 3, 1, 2)
    x = F.relu(_conv(p, "Conv_0", x, net["stem"]["stride"]))
    for i in range(len(net["conv_sequences"])):
        s = f"ConvSequence_{i}."
        x = _pool_same(_conv(p, s + "Conv_0", x, padding=1))
        for j in range(net["residual_blocks"]):
            r = f"{s}ResidualBlock_{j}."
            x = x + _conv(p, r + "Conv_1", F.relu(_conv(p, r + "Conv_0", F.relu(x), padding=1)),
                          padding=1)
    x = F.relu(x).permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return F.relu(_dense(p, "Dense_0", x))


def _mlp(p, hidden, layers):
    for i in range(layers):
        hidden = F.relu(_dense(p, f"Dense_{i}", hidden))
    return hidden


def policy(cfg: dict, params: dict, grid, dt=torch.float32):
    """(logits of each head, value) of the agent on ``grid`` (N, H, W, 3)."""
    hidden = torso(cfg, params["network_params"], grid, dt)
    net, actor, critic = cfg["network"], params["actor_params"], params["critic_params"]
    a = _mlp(actor, hidden, len(net["actor"]))
    logits = [_dense(actor, f"Dense_{len(net['actor']) + i}", a)
              for i in range(len(cfg["action_heads"]))]
    c = _mlp(critic, hidden, len(net["critic"]))
    return logits, _dense(critic, f"Dense_{len(net['critic'])}", c)[:, 0]


def log_probs(logits, actions):
    """(N, heads) log-probabilities of ``actions`` (N, heads)."""
    return torch.stack([F.log_softmax(lg, -1).gather(-1, actions[:, i, None].long())[:, 0]
                        for i, lg in enumerate(logits)], 1)


def entropies(logits):
    return torch.stack([-(F.softmax(lg, -1) * F.log_softmax(lg, -1)).sum(-1) for lg in logits], 1)


def evaluate(cfg: dict, params: dict, grid, actions, dt=torch.float32):
    """(log-probs of ``actions``, values) in blocks of :data:`BLOCK`."""
    lps, vals = [], []
    for i in range(0, grid.shape[0], BLOCK):
        logits, value = policy(cfg, params, grid[i:i + BLOCK], dt)
        lps.append(log_probs(logits, actions[i:i + BLOCK]))
        vals.append(value)
    return torch.cat(lps).float(), torch.cat(vals).float()


# --- the loss, GAE, the optimizer --------------------------------------------------------


def ppo_loss(cfg: dict, params: dict, mb: dict, dt=torch.float32):
    """``(loss, (policy, value, entropy, approx_kl))`` on minibatch ``mb``
    (``grid``, ``actions``, ``logprobs``, ``advantages``, ``returns``,
    ``values``)."""
    hp = cfg["ppo"]
    logits, value = policy(cfg, params, mb["grid"], dt)
    logratio = log_probs(logits, mb["actions"]) - mb["logprobs"].to(dt)
    ratio = torch.exp(logratio)
    approx_kl = ((ratio - 1) - logratio).mean()
    adv = mb["advantages"].to(dt)[:, None].expand_as(ratio)
    if hp["norm_adv"]:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    c = hp["clip_coef"]
    pg = torch.maximum(-adv * ratio, -adv * torch.clamp(ratio, 1 - c, 1 + c)).mean()
    ret, old = mb["returns"].to(dt), mb["values"].to(dt)
    unclipped = 0.5 * ((value - ret) ** 2).mean()
    if hp["clip_vloss"]:
        clipped = (old + torch.clamp(value - old, -c, c) - ret) ** 2
        v_loss = 0.5 * torch.maximum(unclipped, clipped).mean()
    else:
        v_loss = unclipped
    ent = entropies(logits).mean()
    loss = pg - hp["ent_coef"] * ent + hp["vf_coef"] * v_loss
    return loss, (pg, v_loss, ent, approx_kl.detach())


def loss_and_grads(cfg: dict, params: dict, mb: dict, dt=torch.float32):
    """(the five losses (5,) float32, the gradients as float32 trees)."""
    live = {g: {k: t.detach().float().requires_grad_() for k, t in d.items()}
            for g, d in params.items()}
    leaves = [t for d in live.values() for t in d.values()]
    with torch.enable_grad():
        loss, aux = ppo_loss(cfg, live, mb, dt)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(t) if g is None else g.float() for t, g in zip(leaves, grads)])
    tree = {g: {k: next(it) for k in d} for g, d in live.items()}
    return torch.stack([v.detach().float() for v in (loss,) + aux]), tree


def gae(hp: dict, rewards, values, dones, next_value, next_done, dt=torch.float32):
    """Advantages (T, N): ``dones[t]`` marks step t's observation as an
    episode's first, ``next_*`` the observation after the last step."""
    dones = torch.cat([dones, next_done[None]])[1:].to(dt)
    values = torch.cat([values, next_value[None]]).to(dt)
    rewards = rewards.to(dt)
    adv = torch.zeros_like(values[0])
    out = []
    for t in reversed(range(rewards.shape[0])):
        keep = 1.0 - dones[t]
        delta = rewards[t] + hp["gamma"] * values[t + 1] * keep - values[t]
        adv = delta + hp["gamma"] * hp["gae_lambda"] * keep * adv
        out.append(adv)
    return torch.stack(out[::-1]).float()


def adam(cfg: dict, grads: dict, opt: dict, params: dict, batch: int, dt=torch.float32):
    """The global-norm clip and one Adam step: (params, opt) after it."""
    hp = cfg["ppo"]
    b1, b2, eps = hp["adam_b1"], hp["adam_b2"], hp["adam_eps"]
    grads = {g: {k: t.to(dt) for k, t in d.items()} for g, d in grads.items()}
    norm = torch.sqrt(sum((t * t).sum() for d in grads.values() for t in d.values()))
    keep = norm < hp["max_grad_norm"]
    grads = {g: {k: torch.where(keep, t, t / norm * hp["max_grad_norm"]) for k, t in d.items()}
             for g, d in grads.items()}
    count = opt["count"]
    lr = hp["learning_rate"]
    if hp["anneal_lr"]:
        iterations = max(hp["total_timesteps"] // batch, 1)
        updates = hp["num_minibatches"] * hp["update_epochs"]  # an iteration's
        frac = 1.0 - (count // updates).to(torch.float32) / iterations
        lr = lr * torch.clamp(frac, min=0.0)
    t = (count + 1).to(torch.float32)
    c1, c2 = (1 - torch.pow(b1, t)).to(dt), (1 - torch.pow(b2, t)).to(dt)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=count.device).to(dt)
    out = {"params": {}, "mu": {}, "nu": {}}
    for g_name, d in params.items():
        for k in out:
            out[k][g_name] = {}
        for name, p in d.items():
            g = grads[g_name][name]
            mu = (1 - b1) * g + b1 * opt["mu"][g_name][name].to(dt)
            nu = (1 - b2) * g * g + b2 * opt["nu"][g_name][name].to(dt)
            step = -lr * (mu / c1) / (torch.sqrt(nu / c2) + eps)
            out["params"][g_name][name] = (p.to(dt) + step).float()
            out["mu"][g_name][name], out["nu"][g_name][name] = mu.float(), nu.float()
    return out["params"], {"count": count + 1, "mu": out["mu"], "nu": out["nu"]}


# --- the env -----------------------------------------------------------------------------


def award(p: A.Params, grid, low: bool = False):
    """``-(f / (t + f + 1e-8))`` of each env's grid."""
    ft = torch.bfloat16 if low else torch.float32
    t = (grid == p.tree).sum((1, 2)).to(ft)
    f = (grid == p.fire).sum((1, 2)).to(ft)
    return (-(f / (t + f + 1e-8))).to(torch.float32)


def env_step(p: A.Params, s: dict, actions, low: bool = False):
    """One step with the auto-reset: (the state after it, the reward the
    trainer stores: that of the merged grid)."""
    s = A.step(p, s, actions, low)
    return s, award(p, s["true_grid"], low)


# --- the control -------------------------------------------------------------------------


def init_params(cfg: dict, gen: torch.Generator, device) -> dict:
    """Params of the configuration's shapes, in its init's distributions,
    drawn from ``gen``."""
    net = cfg["network"]

    def orth(shape, gain):
        w = torch.empty(shape)
        torch.nn.init.orthogonal_(w, gain=gain, generator=gen)
        return w

    def lecun(shape):
        fan_in = math.prod(shape[1:])
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        w = torch.empty(shape)
        torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
        return w

    def layer(tree, name, w):
        tree[name + ".weight"], tree[name + ".bias"] = w, torch.zeros(w.shape[0])

    root2 = math.sqrt(2.0)
    torso_p, h, w, cin = {}, cfg["nrows"], cfg["ncols"], 3
    stem = net["stem"]
    layer(torso_p, "Conv_0", orth((stem["channels"], cin, stem["kernel"], stem["kernel"]), root2))
    k, st = stem["kernel"], stem["stride"]
    h, w, cin = (h - k) // st + 1, (w - k) // st + 1, stem["channels"]
    for i, c in enumerate(net["conv_sequences"]):
        layer(torso_p, f"ConvSequence_{i}.Conv_0", lecun((c, cin, 3, 3)))
        for j in range(net["residual_blocks"]):
            for k in range(2):
                layer(torso_p, f"ConvSequence_{i}.ResidualBlock_{j}.Conv_{k}",
                      orth((c, c, 3, 3), root2))
        h, w, cin = -(-h // 2), -(-w // 2), c
    layer(torso_p, "Dense_0", orth((net["dense"], h * w * cin), root2))

    def mlp(widths, outs):
        tree, fan_in = {}, net["dense"]
        for i, width in enumerate(widths):
            layer(tree, f"Dense_{i}", orth((width, fan_in), root2))
            fan_in = width
        for i, (d, gain) in enumerate(outs):
            layer(tree, f"Dense_{len(widths) + i}", orth((d, fan_in), gain))
        return tree

    params = {"actor_params": mlp(net["actor"], [(d, 0.01) for d in cfg["action_heads"]]),
              "critic_params": mlp(net["critic"], [(1, 1.0)]),
              "network_params": torso_p}
    return {g: {k: t.to(device) for k, t in sorted(d.items())} for g, d in params.items()}


def _gumbel_actions(logits, gen):
    u = [torch.rand(lg.shape, generator=gen, device=lg.device) for lg in logits]
    return torch.stack([torch.argmax(lg.float() - torch.log(-torch.log(x)), -1)
                        for lg, x in zip(logits, u)], 1).to(torch.int32)


def control_record(cfg: dict, seed: int, envs: int, terrain: dict, device, low: bool = True):
    """An iteration of the reference, in bfloat16 with ``low``, in the
    program's place from the run's reset: the params drawn from the seed,
    actions by the Gumbel trick from a generator of the seed, minibatches by
    its permutations; the record :func:`check` reads."""
    dt = torch.bfloat16 if low else torch.float32
    hp = cfg["ppo"]
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    params = init_params(cfg, torch.Generator().manual_seed(int(seed)), dev)
    zeros = {g: {k: torch.zeros_like(t) for k, t in d.items()} for g, d in params.items()}
    opt = {"count": torch.zeros((), dtype=torch.int32, device=dev), "mu": zeros, "nu": zeros}
    p = A.Params(cfg, dev)
    s = A.initial(p, seed, envs, {k: v.to(dev) for k, v in terrain.items()}, dev)
    env_keys = ENV_LEAVES
    start = {k: s[k] for k in env_keys}
    done = torch.zeros(envs, dtype=torch.bool, device=dev)
    rows = {k: [] for k in ("grid_obs", "actions", "logprobs", "values", "rewards", "dones")}
    with torch.no_grad():
        for _ in range(hp["num_steps"]):
            logits, value = policy(cfg, params, s["rgb"], dt)
            actions = _gumbel_actions(logits, gen)
            rows["grid_obs"].append(s["rgb"])
            rows["actions"].append(actions)
            rows["logprobs"].append(log_probs(logits, actions).float())
            rows["values"].append(value.float())
            rows["dones"].append(done)
            s, reward = env_step(p, s, actions, low)
            done = torch.zeros_like(done)  # conditional_reset clears them
            rows["rewards"].append(reward)
        record = {k: torch.stack(v) for k, v in rows.items()}
        next_value = policy(cfg, params, s["rgb"], dt)[1].float()
        adv = gae(hp, record["rewards"], record["values"], record["dones"], next_value, done, dt)
    record.update(params=params, opt=opt, env_start=start, done_start=record["dones"][0],
                  next_obs=s["rgb"], next_done=done, env_end={k: s[k] for k in env_keys},
                  advantages=adv, returns=(adv.to(dt) + record["values"].to(dt)).float())
    flat = {k: record[k].flatten(0, 1) for k in ("grid_obs", "actions", "logprobs",
                                                 "advantages", "returns", "values")}
    batch = flat["values"].shape[0]
    heads = len(cfg["action_heads"])
    mbs, orders = [], []
    for _ in range(hp["update_epochs"]):
        orders.append(torch.randperm(batch, generator=gen, device=dev))
        for idx in orders[-1].reshape(hp["num_minibatches"], -1):
            mb = {"grid": flat["grid_obs"][idx], "actions": flat["actions"][idx],
                  "logprobs": flat["logprobs"][idx], "advantages": flat["advantages"][idx],
                  "returns": flat["returns"][idx], "values": flat["values"][idx]}
            mb["advantage_heads"] = mb["advantages"][:, None].expand(-1, heads)
            losses, grads = loss_and_grads(cfg, params, mb, dt)
            new_params, new_opt = adam(cfg, grads, opt, params, batch, dt)
            mb.update(losses=losses, params=params, opt=opt, grads=grads,
                      params_after=new_params, opt_after=new_opt)
            mbs.append(mb)
            params, opt = new_params, new_opt
    record.update(minibatches=mbs, orders=orders, params_end=params, opt_end=opt)
    return record


# --- the check ---------------------------------------------------------------------------

# Each limit lies between the program's greatest reading over its seeds on
# an H100 (convolutions in TF32, unit roundoff 2**-11; the rest float32) and
# the bfloat16 control's least (unit roundoff 2**-8), near their geometric
# mean, 2.4x or more from each, but for grad_rel_err; the pairs are given
# below (20 runs of the program, 9 seeds of the control) and in PERF.md.
# The numbers ending in _values_wrong are counts of values that differ:
# exact.
LIMITS = {
    # the env steps under the program's actions: integer grids, threefry
    # draws and float32 arithmetic in the same order, as the env cells
    # (0; control 9,354)
    "env_values_wrong": 0,
    # the iteration run again from its input carry: a pure function,
    # deterministic cuDNN algorithms
    "rerun_values_wrong": 0,
    # the optimizer steps chained: the first minibatch's params and Adam
    # state are the iteration's input, each next one's the step before's
    # output, the iteration's output the last step's; the same tensors
    # handed on, so exact (0; control 0: it chains them too)
    "chain_values_wrong": 0,
    # each epoch's order a permutation of all the samples, and each
    # minibatch's rows (observations, actions, log-probs, advantages on
    # every head, returns, values) the rollout storage's at its slice of
    # the order: indexing copies, so exact (0; control 0)
    "minibatch_values_wrong": 0,
    # largest |log-prob| difference of a taken action over the rollout's
    # samples and heads: the torso's TF32 rounding reaches the logits
    # through the 0.01-gain heads (program 3.0e-4; control 8.0e-3)
    "logprob_gap": 1.5e-3,
    # largest value difference over the rollout over the largest |value|:
    # TF32 in the torso (4.4e-4; 1.6e-2)
    "value_rel_gap": 2.5e-3,
    # GAE over the program's rewards and values with the reference's
    # bootstrap value: float32 sums and the bootstrap's TF32 rounding, over
    # the largest |advantage| (2.2e-3; 0.107) and |return| (3.7e-4; 2.1e-2)
    "advantage_rel_gap": 1.5e-2,
    "return_rel_gap": 3e-3,
    # each minibatch's losses at the program's params entering it, each gap
    # in the units of loss_scales: TF32 reaches the value loss through the
    # values (2.9e-3; 2.6e-2), the total through it (2.9e-3; 5.6e-2), the
    # policy loss, entropy and approx_kl through the log-probs (9.7e-6;
    # 1.0e-3), (2.3e-5; 3.1e-3), (7.8e-6; 7.2e-4)
    "loss_gap.loss": 1.2e-2,
    "loss_gap.policy_loss": 1e-4,
    "loss_gap.value_loss": 1.1e-2,
    "loss_gap.entropy_loss": 3e-4,
    "loss_gap.approx_kl": 8e-5,
    # largest ||g - g_ref|| / ||g_ref|| of the whole gradient over the
    # minibatches: TF32 products in the convolutions' backward, summed over
    # 256 x 126^2 positions with cancellation (9.3e-2, geometric mean 2.7e-2;
    # with TF32 off the program reads 4e-6 to 4.5e-4).  The control reads
    # 0.228 to 1.97, under this limit on 2 of 9 seeds: the two spread over
    # a factor of 8-9 each and meet in their tails, so no limit fits
    # between them with room; this one keeps 3x above the program, and the
    # control fails the other limits on every seed.  Leaf by leaf the ratio
    # is ill-conditioned where a leaf's gradient nearly cancels (the value
    # head's bias, the mean of v - R: the program read up to 0.285 there),
    # so the check prints the worst leaves and limits the whole
    "grad_rel_err": 0.3,
    # the clip and the Adam step on the program's own gradients, the params'
    # move and the moments: float32 rounding of the same formulas (9.9e-5;
    # 3.6)
    "adam_rel_err": 1e-3,
}


def loss_scales(hp: dict, losses):
    """What each loss's gap is measured in: the total's by the sum of its
    terms' sizes, the value loss and the entropy by their own; the policy
    loss (advantages normalised to 1) and ``approx_kl`` in their units."""
    _, pg, v, ent, _ = losses.abs().tolist()
    total = pg + hp["ent_coef"] * ent + hp["vf_coef"] * v
    return torch.tensor([total, 1.0, v, ent, 1.0], dtype=torch.float64).clamp(min=1e-30)


def _rel(a, b):
    """``max|a - b| / max|b|`` over the leaves of two tensors."""
    scale = float(b.abs().max())
    gap = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
    return gap / scale if scale else (0.0 if gap == 0 else math.inf)


def _norm_rel(a, b, base):
    """``||a - b|| / ||base||``: 0 where both vanish."""
    num = float(torch.linalg.vector_norm((a.double() - b.double()).reshape(-1)))
    den = float(torch.linalg.vector_norm(base.double().reshape(-1)))
    return num / den if den else (0.0 if num == 0 else math.inf)


def _env_wrong(cfg: dict, rec: dict, terrain: dict, device) -> int:
    p = A.Params(cfg, device)
    s = dict(rec["env_start"], vdf=terrain["veg_den_factor"].to(device),
             exp_slope=terrain["exp_slope"].to(device))
    steps = rec["actions"].shape[0]
    wrong = values_wrong({"d": rec["dones"][0]}, {"d": rec["done_start"]}, ("d",))
    for t in range(steps):
        s, reward = env_step(p, s, rec["actions"][t])
        seen = {"rgb": rec["grid_obs"][t + 1] if t + 1 < steps else rec["next_obs"],
                "reward": rec["rewards"][t],
                "done": rec["dones"][t + 1] if t + 1 < steps else rec["next_done"]}
        wrong += values_wrong(seen, {"rgb": s["rgb"], "reward": reward,
                                     "done": torch.zeros_like(seen["done"])},
                              ("rgb", "reward", "done"))
    return wrong + values_wrong(rec["env_end"], s, ENV_LEAVES)


def _tree(tree, path="") -> dict:
    """``{path: tensor}`` of a params or optimizer tree."""
    if isinstance(tree, torch.Tensor):
        return {path: tree}
    out = {}
    for k, v in tree.items():
        out.update(_tree(v, f"{path}/{k}"))
    return out


def _differ(seen, ref) -> int:
    """Values of tree ``ref`` that tree ``seen`` does not equal; every one
    where the trees' leaves differ."""
    seen, ref = _tree(seen), _tree(ref)
    if seen.keys() != ref.keys():
        return sum(t.numel() for t in ref.values())
    return values_wrong(seen, ref, ref)


def _chain_wrong(rec: dict) -> int:
    """Values where the minibatches' optimizer steps do not follow one
    another from the iteration's input params and Adam state to its
    output."""
    params, opt, wrong = rec["params"], rec["opt"], 0
    for mb in rec["minibatches"]:
        wrong += _differ(mb["params"], params) + _differ(mb["opt"], opt)
        params, opt = mb["params_after"], mb["opt_after"]
    return wrong + _differ(rec["params_end"], params) + _differ(rec["opt_end"], opt)


ROWS = {"grid_obs": "grid", "actions": "actions", "logprobs": "logprobs",
        "advantages": "advantage_heads", "returns": "returns", "values": "values"}


def _minibatch_wrong(cfg: dict, rec: dict) -> int:
    """Values where the minibatches are not the rollout's samples: an
    epoch's order that is no permutation of all of them, a minibatch that
    is not the storage's rows at its slice of the order, and, for each
    epoch or minibatch missing or extra, its samples."""
    hp = cfg["ppo"]
    epochs, per_epoch = hp["update_epochs"], hp["num_minibatches"]
    flat = {k: rec[k].flatten(0, 1) for k in ROWS}
    heads = len(cfg["action_heads"])
    flat["advantages"] = flat["advantages"][:, None].expand(-1, heads)
    batch = flat["values"].shape[0]
    orders, mbs = rec["orders"], rec["minibatches"]
    wrong = (abs(len(orders) - epochs) * batch
             + abs(len(mbs) - epochs * per_epoch) * (batch // per_epoch))
    every = torch.arange(batch, device=flat["values"].device)
    for e, order in enumerate(orders[:epochs]):
        if order.shape != every.shape:
            wrong += batch
            continue
        wrong += int((torch.sort(order).values != every).sum())
        for j, idx in enumerate(order.reshape(per_epoch, -1)):
            if e * per_epoch + j < len(mbs):
                mb = mbs[e * per_epoch + j]
                wrong += values_wrong({k: mb[v] for k, v in ROWS.items()},
                                      {k: t[idx] for k, t in flat.items()}, ROWS)
    return wrong


def check(cfg: dict, rec: dict, terrain: dict, device) -> dict:
    """The compared numbers of an iteration's record: the program's (see
    ``benchmark/envs/ppo.py``) or the control's."""
    hp = cfg["ppo"]
    dev = torch.device(device)
    with exact_float32(), torch.no_grad():
        numbers = {"env_values_wrong": _env_wrong(cfg, rec, terrain, dev),
                   "chain_values_wrong": _chain_wrong(rec),
                   "minibatch_values_wrong": _minibatch_wrong(cfg, rec)}
        steps, n = rec["values"].shape
        lp, val = evaluate(cfg, rec["params"], rec["grid_obs"].flatten(0, 1),
                           rec["actions"].flatten(0, 1))
        numbers["logprob_gap"] = float((rec["logprobs"].flatten(0, 1).double()
                                        - lp.double()).abs().max())
        numbers["value_rel_gap"] = _rel(rec["values"].flatten(), val)
        next_value = evaluate(cfg, rec["params"], rec["next_obs"],
                              torch.zeros((n, len(cfg["action_heads"])), dtype=torch.int32,
                                          device=dev))[1]
        adv = gae(hp, rec["rewards"], rec["values"], rec["dones"], next_value, rec["next_done"])
        numbers["advantage_rel_gap"] = _rel(rec["advantages"], adv)
        numbers["return_rel_gap"] = _rel(rec["returns"], adv + rec["values"])
        gaps = torch.zeros(len(LOSSES), dtype=torch.float64)
        grad_err = adam_err = 0.0
        leaf_err, seen = {}, []
        for mb in rec["minibatches"]:
            losses, grads = loss_and_grads(cfg, mb["params"], mb)
            seen.append(losses.double().cpu())
            gap = (mb["losses"].double() - losses.double()).abs().cpu()
            gaps = torch.maximum(gaps, gap / loss_scales(hp, seen[-1]))
            refs = [(f"{g}/{k}", mb["grads"][g][k], ref) for g, d in grads.items()
                    for k, ref in d.items()]
            seen_g = torch.cat([a.reshape(-1) for _, a, _ in refs])
            ref_g = torch.cat([b.reshape(-1) for *_, b in refs])
            grad_err = max(grad_err, _norm_rel(seen_g, ref_g, ref_g))
            for name, a, ref in refs:
                leaf_err[name] = max(leaf_err.get(name, 0.0), _norm_rel(a, ref, ref))
            params, opt = adam(cfg, mb["grads"], mb["opt"], mb["params"], steps * n)
            for g, d in params.items():
                for k, ref in d.items():
                    adam_err = max(
                        adam_err, _norm_rel(mb["params_after"][g][k], ref, ref - mb["params"][g][k]),
                        _norm_rel(mb["opt_after"]["mu"][g][k], opt["mu"][g][k], opt["mu"][g][k]),
                        _norm_rel(mb["opt_after"]["nu"][g][k], opt["nu"][g][k], opt["nu"][g][k]))
        numbers.update({f"loss_gap.{k}": float(v) for k, v in zip(LOSSES, gaps)})
        numbers["grad_rel_err"] = grad_err
        numbers["adam_rel_err"] = adam_err
    worst = sorted(leaf_err.items(), key=lambda x: -x[1])[:3]
    seen = torch.stack(seen)
    print(f"[benchmark] check: largest errors of a gradient leaf {worst}; the reference's losses "
          f"{dict(zip(LOSSES, seen.min(0).values.tolist()))} to "
          f"{dict(zip(LOSSES, seen.max(0).values.tolist()))}", file=sys.stderr, flush=True)
    return numbers
