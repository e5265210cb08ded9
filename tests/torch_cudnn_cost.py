"""What do cuDNN's deterministic algorithms cost the trainer on a card?
``PPOTrainer`` at ``scripts/run``'s defaults (8 envs at 256², 128 steps, 4
epochs of 4 minibatches of 256, the fused Alexandridis kernel), TF32 at
torch's default.  Not a pytest file: run it on one card,

    python3 tests/torch_cudnn_cost.py [--pairs 3]

The trainer runs its rollout and update under
``gymca_torch.agents.ppo.cudnn_deterministic``.  Here each pair runs one
``train_iteration`` from one carry with that context as it is ("on") and
one with it replaced by a context that sets cuDNN's default algorithms
("off", ``cudnn.deterministic`` False), autotuning off in both, alternating
which runs first; each iteration's rollout and update are timed apart, each
to a ``torch.cuda.synchronize()``.  Every iteration is compared with the
first of its setting: "on" must repeat bit for bit.

Prints the card's ``nvidia-smi`` name and power limit and one
``CUDNN_COST {...}`` JSON line (seconds per part and setting, samples/s of
each iteration, their medians, the gaps); exits non-zero unless every "on"
iteration equals the first bit for bit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gymca_torch import rng  # noqa: E402
from gymca_torch.agents import ppo  # noqa: E402
from gymca_torch.agents.ppo import EpisodeStatistics, PPOTrainer  # noqa: E402
from gymca_torch.run import args_to_structured_args, build_env, parse_args  # noqa: E402

RUN_ARGV = ["-n", "8", "-z", "256"]


@contextlib.contextmanager
def cudnn_default():
    """cuDNN's default algorithms, autotuning off, inside the block."""
    flags = torch.backends.cudnn
    saved = flags.deterministic, flags.benchmark
    flags.deterministic, flags.benchmark = False, False
    try:
        yield
    finally:
        flags.deterministic, flags.benchmark = saved


def gap(a, b):
    """Max |difference| over the params and the metrics of two iterations."""
    p = max((a[0].params[g][k] - b[0].params[g][k]).abs().max().item()
            for g in a[0].params for k in a[0].params[g])
    m = max(abs(float(a[-1][k]) - float(b[-1][k])) for k in b[-1])
    return max(p, m)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=3)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this check runs on a card", file=sys.stderr)
        return 1
    args = args_to_structured_args(parse_args(RUN_ARGV))
    env = build_env(args)
    tr = PPOTrainer(env, args, key=rng.key(args.exp.seed))
    obs, info = env.reset()
    n = args.env.num_envs
    carry = (tr.agent_state, EpisodeStatistics.create(n), obs,
             torch.zeros(n, dtype=torch.bool, device="cuda"), info, tr.key)
    real = ppo.cudnn_deterministic

    def iteration(setting):
        ppo.cudnn_deterministic = real if setting == "on" else cudnn_default
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            after, storage = tr.rollout(*carry)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, metrics, _, _ = tr.learn(after[0], after[2], after[3], storage, after[5])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        finally:
            ppo.cudnn_deterministic = real
        return (state, metrics), t1 - t0, t2 - t1

    iteration("on")  # warm: cuDNN's plans, the kernel build
    iteration("off")
    first, gaps = {}, {"on": [], "off": []}
    seconds = {s: {"rollout": [], "update": []} for s in ("on", "off")}
    for i in range(a.pairs):
        for setting in (("off", "on") if i % 2 == 0 else ("on", "off")):
            res, roll_s, upd_s = iteration(setting)
            first.setdefault(setting, res)
            gaps[setting].append(gap(res, first[setting]))
            seconds[setting]["rollout"].append(roll_s)
            seconds[setting]["update"].append(upd_s)
            print(f"pair {i} {setting}: rollout {roll_s:.3f}s, update {upd_s:.3f}s, gap to "
                  f"the first {setting} iteration {gaps[setting][-1]}", flush=True)
    cross = gap(first["on"], first["off"])
    batch = args.batch_size
    sps = {s: [batch / (r + u) for r, u in zip(v["rollout"], v["update"])]
           for s, v in seconds.items()}
    out = {"pairs": a.pairs, "cell": RUN_ARGV, "batch": batch,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32, "seconds": seconds,
           "samples_per_s": sps,
           "median_samples_per_s": {s: statistics.median(v) for s, v in sps.items()},
           "median_update_s": {s: statistics.median(v["update"]) for s, v in seconds.items()},
           "median_rollout_s": {s: statistics.median(v["rollout"])
                                for s, v in seconds.items()},
           "max_gap": {s: max(v) for s, v in gaps.items()}, "on_vs_off_gap": cross}
    ok = out["max_gap"]["on"] == 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print("CUDNN_COST " + json.dumps({"ok": ok, **out}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
