"""Does data-parallel PPO repeat itself on a card?  A check of
``DataParallelPPO`` (a world of one rank on NCCL) against ``PPOTrainer`` at
``scripts/run``'s defaults (8 envs at 256², the fused Alexandridis kernel).
Not a pytest file: run it on one card,

    python3 tests/torch_dp_determinism.py [--pairs 10]

1. ``DataParallelPPO.train(2)`` from the same key under each TF32 / cuDNN
   setting, and once with a ``group_mean`` that hands back contiguous copies
   instead of each gradient's own strides; the last iteration's losses.
2. ``--pairs`` pairs of one ``train_iteration`` each of DP and the trainer
   from the same weights and key, TF32 off and cuDNN's deterministic
   algorithms, alternating which runs first: every iteration against the
   first, bit for bit, and each one's seconds to a synchronize.
3. One iteration of each under ``torch.use_deterministic_algorithms(True,
   warn_only=True)``: the ops it flags as nondeterministic.

Prints the card's ``nvidia-smi`` name and power limit and one
``DP_DETERMINISM {...}`` JSON line; exits non-zero unless every iteration
of 2 and 3 equals the first bit for bit.
"""

from __future__ import annotations

import argparse
import json
import socket
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gymca_torch import rng  # noqa: E402
from gymca_torch.agents import ppo  # noqa: E402
from gymca_torch.agents.ppo import EpisodeStatistics, PPOTrainer  # noqa: E402
from gymca_torch.parallel.mesh import initialize_distributed, make_mesh  # noqa: E402
from gymca_torch.parallel.sharded import DataParallelPPO  # noqa: E402
from gymca_torch.run import args_to_structured_args, build_env, parse_args  # noqa: E402

RUN_ARGV = ["-n", "8", "-z", "256"]
LOSSES = ("loss", "policy_loss", "value_loss")
# (cudnn.allow_tf32, cudnn.deterministic)
SETTINGS = {"tf32": (True, False), "tf32_deterministic": (True, True),
            "fp32": (False, False), "fp32_deterministic": (False, True)}


def _contiguous_group_mean(tensors, group, _real=ppo.group_mean):
    return [t.contiguous() for t in _real(tensors, group)]


def _set(tf32, det):
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = tf32, det


def _gap(a, b):
    """Max |difference| of the params and of the metrics of two iterations."""
    p = max((a[0].params[g][k] - b[0].params[g][k]).abs().max().item()
            for g in a[0].params for k in a[0].params[g])
    m = max(abs(float(a[-1][k]) - float(b[-1][k])) for k in b[-1])
    return p, m


def train_losses(args) -> dict:
    """1: ``train(2)``'s last losses per setting and with contiguous copies."""
    out = {}
    runs = [(name, s, ppo.group_mean) for name, s in SETTINGS.items()]
    runs.append(("tf32_contiguous_copies", SETTINGS["tf32"], _contiguous_group_mean))
    real = ppo.group_mean
    for name, setting, mean in runs:
        _set(*setting)
        ppo.group_mean = mean
        try:
            dp = DataParallelPPO(build_env(args), args, make_mesh(1),
                                 key=rng.key(args.exp.seed))
            _, history = dp.train(2)
        finally:
            ppo.group_mean = real
        out[name] = {k: history[-1][k] for k in LOSSES}
        print(f"train(2) {name}: {out[name]}", flush=True)
    _set(*SETTINGS["tf32"])
    return out


def pairs(args, n_pairs: int) -> dict:
    """2 and 3: alternating DP and trainer iterations, compared and timed."""
    env = build_env(args)
    dp = DataParallelPPO(env, args, make_mesh(1), key=rng.key(args.exp.seed))
    start = dp.trainer.agent_state
    n = args.env.num_envs

    def timed(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*a)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def dp_iteration():
        dp.trainer.agent_state = start
        return timed(dp.train_iteration, *dp.init_carry())

    def trainer_iteration():
        tr = PPOTrainer(env, args, key=rng.key(args.exp.seed))
        obs, info = env.reset()
        return timed(tr.train_iteration, tr.agent_state, EpisodeStatistics.create(n), obs,
                     torch.zeros(n, dtype=torch.bool, device="cuda"), info,
                     rng.split(tr.key, 1)[0])

    _set(*SETTINGS["fp32_deterministic"])
    try:
        first, seconds, gaps = None, {"dp": [], "trainer": []}, []
        for i in range(n_pairs):
            order = [("trainer", trainer_iteration), ("dp", dp_iteration)]
            for name, fn in (order if i % 2 == 0 else order[::-1]):
                res, dt = fn()
                first = res if first is None else first
                seconds[name].append(dt)
                gaps.append(_gap(res, first))
                print(f"pair {i} {name}: {dt:.3f}s, gap to the first trainer {gaps[-1]}",
                      flush=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                checked = [trainer_iteration()[0], dp_iteration()[0]]
            finally:
                torch.use_deterministic_algorithms(False)
    finally:
        _set(*SETTINGS["tf32"])
    flagged = sorted({str(w.message).split("\n")[0][:200] for w in caught
                      if "deterministic" in str(w.message).lower()})
    checked_gaps = [_gap(c, first) for c in checked]
    return {"pairs": n_pairs, "max_param_gap": max(g[0] for g in gaps),
            "max_metric_gap": max(g[1] for g in gaps), "seconds": seconds,
            "median_seconds": {k: statistics.median(v) for k, v in seconds.items()},
            "dp_faster_in_pairs": sum(d < t for d, t in zip(seconds["dp"], seconds["trainer"])),
            "flagged_nondeterministic_ops": flagged,
            "under_deterministic_algorithms_gaps": checked_gaps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=10)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this check runs on a card", file=sys.stderr)
        return 1
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize_distributed(f"localhost:{port}", 1, 0)
    try:
        args = args_to_structured_args(parse_args(RUN_ARGV))
        out = {"train2_losses": train_losses(args), **pairs(args, a.pairs)}
    finally:
        dist.destroy_process_group()
    ok = (out["max_param_gap"] == 0 and out["max_metric_gap"] == 0
          and all(g == (0.0, 0.0) for g in out["under_deterministic_algorithms_gaps"]))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print("DP_DETERMINISM " + json.dumps({"ok": ok, **out}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
