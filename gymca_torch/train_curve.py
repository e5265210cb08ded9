"""Run a PPO training curve and write its artifacts (JSON + SVG):
``scripts/train_curve.py`` on the port.

    python3 -m gymca_torch.train_curve --size 256 --num-envs 32 --iters 800 \\
        --bf16 --seed 7 --tag adv256 [--save-params outputs/p.pkl]
    python3 -m gymca_torch.train_curve --size 16 --num-envs 2 --iters 2 --tag t \\
        --out /tmp/curve --device-cpu

Takes ``scripts/train_curve.py``'s flags and defaults and builds the same
``Args`` per curriculum stage, then the port's Advanced env and
``PPOTrainer``; ``--pallas-ca`` sets ``use_fused_ca=True`` (the fused CUDA
kernel on the card; with ``--ca-repeat-mode modf`` the env warns and runs
the XLA-path counterpart, as the JAX package does), and without it the env
runs the XLA-path counterpart, as the script passes ``use_pallas_ca=False``.

* ``--sm-schedule``: speed-multiplier stages; params and the trainer key
  carry across stages, the optimizer starts fresh in each;
* BC warm-start, critic warmup and the kickstart CE run in stage 0 only;
* ``--save-params``: a params blob (``gymca_torch.interop.save_params_blob``)
  that ``python3 -m gymca_torch.eval_policy`` and ``scripts/eval_policy.py``
  both read;
* ``<out>/ppo_curve_<tag>.json``: the config line, every flag, the device
  the run took (``hardware``: the card's name and power limit, or ``cpu``),
  the wall time and the metrics of every iteration; the SVG of the returns
  beside it where matplotlib is installed (else skipped with a note).

Runs on the card; ``--device-cpu`` runs on the CPU instead, and without it
and without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["parse_args", "stages", "make_args", "hardware", "train_curve", "main"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Run a PPO training curve on the port")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--num-envs", type=int, default=32)
    ap.add_argument("--iters", type=int, default=800)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--tag", type=str, required=True)
    ap.add_argument("--out", type=str, default="docs/assets")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--ent-coef", type=float, default=None)
    ap.add_argument("--speed-multiplier", type=float, default=1.0,
                    help="curriculum knob: >1 makes fires spread slower relative to the agent")
    ap.add_argument("--pallas-ca", action="store_true",
                    help="train through the fused CUDA Alexandridis kernel")
    ap.add_argument("--ca-repeat-mode", type=str, default="single", choices=("single", "modf"),
                    help="'single' = one CA application a step; 'modf' = classic time-gated "
                         "CA, where speed_multiplier changes the agent/fire speed ratio")
    ap.add_argument("--gamma", type=float, default=None,
                    help="discount (default 0.99; ~0.999 for long modf horizons)")
    ap.add_argument("--gae-lambda", type=float, default=None)
    ap.add_argument("--shape-tree-coef", type=float, default=0.0,
                    help="potential-based shaping: phi += c * trees_frac")
    ap.add_argument("--shape-dist-coef", type=float, default=0.0,
                    help="potential-based shaping: phi -= c * dist(agent, fire centroid)/diag")
    ap.add_argument("--shape-douse-coef", type=float, default=0.0,
                    help="potential-based shaping: phi += c * |doused cells with fire in "
                         "their 5x5 box|/100")
    ap.add_argument("--position-features", action="store_true",
                    help="feed normalized agent position to actor/critic")
    ap.add_argument("--centroid-features", action="store_true",
                    help="also feed the agent->fire-centroid offset")
    ap.add_argument("--sm-schedule", type=str, default=None,
                    help="speed-multiplier curriculum, e.g. '6:0.4,3:0.3,1:0.3' = sm 6 for "
                         "40%% of iters, then 3, then 1; params carry across stages "
                         "(overrides --speed-multiplier)")
    ap.add_argument("--bc-iters", type=int, default=0,
                    help="behavior-cloning warm-start iterations from the greedy-fire "
                         "demonstrator before PPO")
    ap.add_argument("--critic-warmup-iters", type=int, default=0,
                    help="PPO iterations with torso+actor frozen after BC")
    ap.add_argument("--kickstart-coef", type=float, default=0.0,
                    help="auxiliary CE toward the greedy demonstrator, annealed to 0")
    ap.add_argument("--kickstart-decay", type=int, default=0,
                    help="iterations over which the kickstart CE anneals (0 = whole run)")
    ap.add_argument("--save-params", type=str, default=None,
                    help="write the final params (+ run config) here for eval_policy")
    ap.add_argument("--device-cpu", action="store_true",
                    help="run on the CPU instead of the card")
    return ap.parse_args(argv)


def stages(a):
    """Curriculum stages ``[(speed_multiplier, iterations)]``."""
    if not a.sm_schedule:
        return [(a.speed_multiplier, a.iters)]
    parts = []
    for part in a.sm_schedule.split(","):
        sm_s, frac_s = part.split(":")
        parts.append((float(sm_s), float(frac_s)))
    total = sum(f for _, f in parts)
    return [(sm, max(int(round(a.iters * f / total)), 1)) for sm, f in parts]


def make_args(a, sm: float, iters: int, stage_i: int):
    """The trainer's ``Args`` for one stage: BC, critic warmup and the
    kickstart CE belong to the start of training, so only stage 0 has them."""
    from gymca_torch.agents.args import Args, EnvArgs, ExperimentArgs, PPOArgs, \
        VisualizationArgs

    ppo_kwargs = {"shape_tree_coef": a.shape_tree_coef,
                  "shape_dist_coef": a.shape_dist_coef,
                  "shape_douse_coef": a.shape_douse_coef,
                  "kickstart_coef": a.kickstart_coef if stage_i == 0 else 0.0,
                  "kickstart_decay_iters": a.kickstart_decay}
    for name, value in (("learning_rate", a.lr), ("ent_coef", a.ent_coef), ("gamma", a.gamma),
                        ("gae_lambda", a.gae_lambda)):
        if value is not None:
            ppo_kwargs[name] = value
    return Args(
        ppo=PPOArgs(**ppo_kwargs),
        env=EnvArgs(num_envs=a.num_envs, size=a.size, speed_multiplier=sm),
        viz=VisualizationArgs(),
        exp=ExperimentArgs(
            total_timesteps=iters * a.num_envs * 128, num_ppo_steps=128, seed=a.seed,
            bf16_compute=a.bf16, position_features=a.position_features,
            centroid_features=a.centroid_features,
            critic_warmup_iters=a.critic_warmup_iters if stage_i == 0 else 0),
    )


def hardware(device) -> str:
    """The device a run took: the card's name and power limit, or ``cpu``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    name = torch.cuda.get_device_name(dev)
    try:
        from gymca_torch.probes.timing import card

        return f"{name}, power limit {card().split(',')[-1].strip()}"
    except (OSError, subprocess.SubprocessError):
        return f"{name}, power limit not read"


def _config_line(a) -> str:
    overrides = []
    if a.lr is not None:
        overrides.append(f"lr={a.lr:g}")
    if a.ent_coef is not None:
        overrides.append(f"ent={a.ent_coef:g}")
    if a.speed_multiplier != 1.0:
        overrides.append(f"speed_mult={a.speed_multiplier:g}")
    if a.ca_repeat_mode != "single":
        overrides.append(f"ca={a.ca_repeat_mode}")
    if a.pallas_ca:
        overrides.append("pallas-ca")
    return (f"AdvancedBulldozer {a.size}x{a.size}, {a.num_envs} envs, "
            f"{'bf16' if a.bf16 else 'f32'}, seed {a.seed}, "
            + (" ".join(overrides) + " PPO" if overrides else "default PPO"))


def _write_svg(path: Path, title: str, steps, rets, valid) -> bool:
    """The return curve as an SVG; False where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(steps[valid], rets[valid], lw=0.8, alpha=0.4, color="tab:blue")
    if valid.sum() > 20:
        k = max(valid.sum() // 40, 1)
        smooth = np.convolve(rets[valid], np.ones(k) / k, mode="valid")
        ax.plot(steps[valid][k - 1:], smooth, lw=2, color="tab:blue",
                label=f"episodic return (smoothed x{k})")
        ax.legend()
    ax.set_xlabel("env steps")
    ax.set_ylabel("mean episodic return")
    ax.set_title(title)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return True


def train_curve(a, device=None) -> dict:
    """Train through every stage, write the artifacts; returns the JSON blob."""
    from gymca_torch import interop, rng
    from gymca_torch.agents.ppo import PPOTrainer
    from gymca_torch.config import resolve_device
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv

    dev = resolve_device(device)
    plan = stages(a)
    history = []
    carry_state, carry_key = None, None
    t0 = time.time()
    for stage_i, (sm, stage_iters) in enumerate(plan):
        env = AdvancedForestFireBulldozerEnv(
            a.size, a.size, key=rng.key(a.seed, device=dev), num_envs=a.num_envs,
            speed_multiplier=sm, use_fused_ca=a.pallas_ca, ca_repeat_mode=a.ca_repeat_mode,
            device=dev)
        trainer = PPOTrainer(env, make_args(a, sm, stage_iters, stage_i),
                             key=rng.key(a.seed, device=dev), device=dev)
        if carry_state is not None:
            # Params carry across stages; the optimizer state does not: a
            # carried Adam count would push the stage's linear LR anneal
            # negative.
            trainer.agent_state = trainer.agent_state.replace(params=carry_state.params)
            trainer.key = carry_key
        if len(plan) > 1:
            print(f"[stage {stage_i + 1}/{len(plan)}] sm={sm} iters={stage_iters}", flush=True)
        if stage_i == 0 and a.bc_iters:
            def bc_log(it, m):
                if it % 10 == 0 or it == 1:
                    print(f"[bc] iter {it}/{a.bc_iters}: loss={m['bc_loss']:.4f} "
                          f"match={m['bc_match']:.3f}", flush=True)
            trainer.bc_pretrain(a.bc_iters, log_fn=bc_log)

        def log_fn(iteration, metrics, _sm=sm):
            metrics = dict(metrics)
            metrics["speed_multiplier"] = _sm
            history.append(metrics)
            if iteration % 20 == 0 or iteration == 1:
                print(f"iter {len(history)}/{a.iters}: SPS={metrics['SPS']} "
                      f"return={metrics.get('episodic_return', float('nan')):.2f} "
                      f"loss={metrics.get('loss', float('nan')):.4f}", flush=True)

        trainer.train(num_iterations=stage_iters, log_fn=log_fn)
        carry_state, carry_key = trainer.agent_state, trainer.key
    wall = time.time() - t0

    if a.save_params:
        interop.save_params_blob(
            a.save_params, carry_state.params, size=a.size, num_envs=a.num_envs,
            seed=a.seed, ca_repeat_mode=a.ca_repeat_mode,
            position_features=a.position_features, centroid_features=a.centroid_features,
            bf16=a.bf16)
        print(f"saved params -> {a.save_params}")

    out_dir = Path(a.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    blob = {
        "config": _config_line(a),
        "args": {k: v for k, v in vars(a).items() if k not in ("out", "device_cpu")},
        "hardware": hardware(dev),
        "wall_seconds": round(wall, 1),
        "history": [{k: round(float(v), 4) for k, v in m.items()} for m in history],
    }
    jpath = out_dir / f"ppo_curve_{a.tag}.json"
    jpath.write_text(json.dumps(blob))

    steps = np.asarray([m["global_step"] for m in history])
    rets = np.asarray([m.get("episodic_return", np.nan) for m in history])
    valid = (rets != 0.0) & ~np.isnan(rets)
    if _write_svg(out_dir / f"ppo_curve_{a.tag}.svg", blob["config"], steps, rets, valid):
        print(f"wrote {jpath} and .svg  (wall {wall:.0f}s)")
    else:
        print(f"wrote {jpath}; no matplotlib here, so no .svg  (wall {wall:.0f}s)")
    if valid.any():
        n = max(valid.sum() // 8, 5)
        print(f"return early {rets[valid][:n].mean():.1f} -> late {rets[valid][-n:].mean():.1f}")
    else:
        print("return early nan -> late nan (no episode finished)")
    return blob


def main(argv=None) -> dict:
    a = parse_args(argv)
    return train_curve(a, device="cpu" if a.device_cpu else None)


if __name__ == "__main__":
    main()
