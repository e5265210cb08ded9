"""Policy-ceiling probe of the Advanced env: ``scripts/exp_policy_ceiling.py``
on the port.

    python3 -m gymca_torch.exp_policy_ceiling [--size 256] [--envs 8] [--steps 6000] \\
        [--speed-multiplier 1.0] [--ca-repeat-mode single]
    python3 -m gymca_torch.exp_policy_ceiling --size 32 --envs 4 --steps 50 --device-cpu

Full-episode returns of the idle, random and greedy-fire hand policies
(``gymca_torch.eval_policy.probe_policies``; greedy-fire is
``gymca_torch.agents.ppo.greedy_fire_action``), each on a fresh
``AdvancedForestFireBulldozerEnv(size, size, key=key(0), num_envs=envs)``
with the fused kernel K2 where ``size >= 128`` and the mode is ``single``,
as the script sets ``use_pallas_ca``.  The first episode of every env, from
the reset, with ``stateless_step`` only: the reward is masked once an env
is done (``eval_policy.episode_returns``).  Step ``t`` takes the ``t``-th
key of ``split(key(17), steps)``; the random policy draws its moves with
``randint(k, (N,), 0, 9)`` and its shots with ``randint(fold_in(k, 1),
(N,), 0, 2)``, as the script.

Prints the script's JSON line per policy (``policy``, ``mean_return``,
``min``, ``max``, ``done_frac``) and its separation line on stderr.  Runs
on the card; ``--device-cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

from gymca_torch import rng
from gymca_torch.config import resolve_device
from gymca_torch.eval_policy import EPISODE_KEY, episode_returns, probe_policies

__all__ = ["parse_args", "make_env", "run_policy", "main"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Policy-ceiling probe of the Advanced env")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--envs", type=int, default=8)
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--speed-multiplier", type=float, default=1.0)
    ap.add_argument("--ca-repeat-mode", type=str, default="single",
                    choices=("single", "modf"))
    ap.add_argument("--device-cpu", action="store_true", help="run on the CPU")
    return ap.parse_args(argv)


def make_env(size: int, envs: int, speed_multiplier: float, ca_repeat_mode: str, device):
    """The script's env: the fused CA at ``size >= 128`` in ``single`` mode."""
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv

    return AdvancedForestFireBulldozerEnv(
        size, size, key=rng.key(0, device=device), num_envs=envs,
        speed_multiplier=speed_multiplier, ca_repeat_mode=ca_repeat_mode,
        use_fused_ca=size >= 128 and ca_repeat_mode == "single", device=device)


def run_policy(env, name: str, steps: int, num_envs: int):
    """One policy over the first episode of every env: ``(summary, returns,
    done)``, the script's summary and the (N,) returns and done mask."""
    policy = dict(probe_policies(num_envs, env.device))[name]
    keys = rng.split(rng.key(EPISODE_KEY, device=env.device), steps)
    ret, done = episode_returns(env, policy, keys, num_envs)
    r, d = ret.cpu().numpy(), done.cpu().numpy()
    summary = {"policy": name, "mean_return": float(r.mean()), "min": float(r.min()),
               "max": float(r.max()), "done_frac": float(d.mean())}
    return summary, ret, done


def main(argv=None) -> list:
    """Every policy: prints its JSON line; returns the summaries."""
    a = parse_args(argv)
    dev = resolve_device("cpu" if a.device_cpu else None)
    results = []
    for name in ("idle", "random", "greedy-fire"):
        env = make_env(a.size, a.envs, a.speed_multiplier, a.ca_repeat_mode, dev)
        r = run_policy(env, name, a.steps, a.envs)[0]
        print(json.dumps(r), flush=True)
        results.append(r)
    spread = results[-1]["mean_return"] - results[0]["mean_return"]
    print(f"# greedy-fire vs idle separation: {spread:+.1f} "
          f"(sm={a.speed_multiplier}, ca={a.ca_repeat_mode})", file=sys.stderr)
    return results


if __name__ == "__main__":
    main()
