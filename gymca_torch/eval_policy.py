"""Greedy evaluation of a trained PPO policy beside hand-policy probes:
``scripts/eval_policy.py`` on the port.

    python3 -m gymca_torch.eval_policy --params outputs/p.pkl --steps 20000 \\
        [--envs 16] [--probes] [--device-cpu]

Loads a params blob (``gymca_torch.interop.load_params_blob``: written by
``python3 -m gymca_torch.train_curve --save-params`` or by
``scripts/train_curve.py``), builds the Advanced env the blob was trained on
(its size and ``ca_repeat_mode``; the env's default CA path, so the fused
CUDA kernel on the card in ``single`` mode), and runs the trained policy
greedily for the FIRST episode of every env: no auto-reset, the reward
masked once an env is done.  ``--probes`` runs the idle, random and
greedy-fire policies under the same protocol.  Each run prints one JSON line
(``mean_return``, ``std_return``, ``min``, ``max``, ``done_frac``,
``policy``, ``env_key``), the script's numbers from the same blob.

The episode loop stays on the device and never waits for it; only the
summary is read back.  Each step's key is a split of ``key(17)``, as in the
script.  Runs on the card; ``--device-cpu`` runs on the CPU instead.
"""

from __future__ import annotations

import argparse
import json

import torch

__all__ = ["greedy_policy_fn", "episode_returns", "run_episodes", "probe_policies",
           "parse_args", "main"]

EPISODE_KEY = 17  # scripts/eval_policy.py's run_episodes draws from key(17)


def greedy_policy_fn(blob, env):
    """``act(obs) -> (N, heads) int32``: the argmax of each head of the
    blob's policy, with its position / centroid features and its compute
    dtype (bfloat16 where the blob was trained so)."""
    from torch.func import functional_call

    from gymca_torch.agents.networks import Actor, Network
    from gymca_torch.agents.ppo import policy_features

    params = blob["params"]
    pos_feat = bool(blob.get("position_features", False))
    cen_feat = bool(blob.get("centroid_features", False))
    dtype = torch.bfloat16 if blob["bf16"] else torch.float32
    # modules for their structure only: the blob's params replace their weights
    network = Network(env.nrows, env.ncols, compute_dtype=dtype,
                      generator=torch.Generator()).to(env.device)
    actor = Actor(128 + 2 * pos_feat + 3 * cen_feat, (9, 2), tuple(env.extension_choices),
                  generator=torch.Generator()).to(env.device)

    def act(obs):
        with torch.no_grad():
            hidden = functional_call(network, params["network_params"], (obs[0],))
            f = policy_features(obs[1], env.nrows, env.ncols, pos_feat, cen_feat)
            if f is not None:
                hidden = torch.cat([hidden, f], dim=-1)
            logits_set = functional_call(actor, params["actor_params"], (hidden,))
        return torch.stack([torch.argmax(lg, dim=-1) for lg in logits_set],
                           dim=1).to(torch.int32)

    return act


def episode_returns(env, act_fn, keys, num_envs: int):
    """The FIRST episode of every env, on the device: ``(returns, done)``
    after ``len(keys)`` steps from a reset, with no auto-reset (an env that
    is done keeps stepping, its reward masked) and no host synchronisation.
    ``act_fn(obs, keys[t])`` gives step ``t``'s actions."""
    obs, info = env.reset()
    ret = torch.zeros((num_envs,), dtype=torch.float32, device=env.device)
    done = torch.zeros((num_envs,), dtype=torch.bool, device=env.device)
    for k in keys:
        acts = act_fn(obs, k)
        obs, reward, term, trunc, info = env.stateless_step(acts, obs, info)
        ret = ret + torch.where(done, 0.0, reward)
        done = done | term | trunc
    return ret, done


def run_episodes(env, act_fn, steps: int, num_envs: int) -> dict:
    """Mean return of the first episode of every env
    (:func:`episode_returns`, step ``t`` keyed by ``split(key(17),
    steps)[t]`` as in the script), read back once and summarised as the
    script summarises it."""
    from gymca_torch import rng

    keys = rng.split(rng.key(EPISODE_KEY, device=env.device), steps)
    ret, done = episode_returns(env, act_fn, keys, num_envs)
    ret, done = ret.cpu().numpy(), done.cpu().numpy()
    return {"mean_return": float(ret.mean()), "std_return": float(ret.std()),
            "min": float(ret.min()), "max": float(ret.max()),
            "done_frac": float(done.mean())}


def probe_policies(num_envs: int, device):
    """The idle, random and greedy-fire policies, ``fn(obs, k) -> (N, 3)
    int32``: idle stands still and never shoots; random draws moves
    ``randint(k, (n,), 0, 9)`` and shots ``randint(fold_in(k, 1), (n,), 0,
    2)``; greedy-fire steps toward the fire centroid and always shoots."""
    from gymca_torch import rng
    from gymca_torch.agents.ppo import greedy_fire_action

    n = num_envs
    idle_action = torch.tensor([4, 0, 0], dtype=torch.int32).to(device).expand(n, 3)
    zeros = torch.zeros((n,), dtype=torch.int32, device=device)

    def idle(obs, k):
        return idle_action

    def random_pol(obs, k):
        return torch.stack([rng.randint(k, (n,), 0, 9),
                            rng.randint(rng.fold_in(k, 1), (n,), 0, 2), zeros], dim=1)

    def greedy_fire(obs, k):
        return greedy_fire_action(obs[1])

    return (("idle", idle), ("random", random_pol), ("greedy-fire", greedy_fire))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Greedy evaluation of a trained PPO policy")
    ap.add_argument("--params", type=str, required=True)
    ap.add_argument("--envs", type=int, default=16)
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--speed-multiplier", type=float, default=1.0)
    ap.add_argument("--env-key", type=int, default=0,
                    help="terrain/initial-state key; a non-default value gives a held-out "
                         "grid population (training envs derive from key 0)")
    ap.add_argument("--probes", action="store_true",
                    help="also run idle/random/greedy-fire under the same protocol")
    ap.add_argument("--device-cpu", action="store_true",
                    help="run on the CPU instead of the card")
    return ap.parse_args(argv)


def main(argv=None):
    """Evaluate; prints one JSON line per policy and returns them."""
    from gymca_torch import interop, rng
    from gymca_torch.config import resolve_device
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv

    a = parse_args(argv)
    dev = resolve_device("cpu" if a.device_cpu else None)
    blob = interop.load_params_blob(a.params, device=dev)

    def make_env():
        return AdvancedForestFireBulldozerEnv(
            blob["size"], blob["size"], key=rng.key(a.env_key, device=dev),
            num_envs=a.envs, ca_repeat_mode=blob["ca_repeat_mode"],
            speed_multiplier=a.speed_multiplier, device=dev)

    env = make_env()
    policy = greedy_policy_fn(blob, env)
    r = run_episodes(env, lambda obs, k: policy(obs), a.steps, a.envs)
    r["policy"] = "trained-greedy"
    r["params"] = a.params
    r["env_key"] = a.env_key
    print(json.dumps(r), flush=True)
    results = [r]
    if a.probes:
        for name, fn in probe_policies(a.envs, dev):
            r = run_episodes(make_env(), fn, a.steps, a.envs)
            r["policy"] = name
            r["env_key"] = a.env_key
            print(json.dumps(r), flush=True)
            results.append(r)
    return results


if __name__ == "__main__":
    main()
