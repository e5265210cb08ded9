"""Train PPO on the Advanced Bulldozer: the training mode of ``scripts/run``.

    python3 -m gymca_torch.run -n 8 -z 256            # on the card
    python3 -m gymca_torch.run -n 4 -z 16 --num-ppo-steps 8 --steps 64 --device-cpu

Takes ``scripts/run``'s Environment, PPO, Visualization and Experiment
flags and builds the same ``Args`` (``args_to_structured_args``), then the
port's ``AdvancedForestFireBulldozerEnv`` and ``run_rollout_loop``.
``--pallas-ca`` / ``--no-pallas-ca`` set ``use_fused_ca`` (the fused CUDA
kernel on the card, or the XLA-path counterpart); neither leaves the env's
default, the kernel on the card.  Metrics go to stdout, checkpoints (full
state, every ``checkpoint_every`` iterations) and the final params
(``<run>_params.pt``) under ``--out-dir``.

Runs on card ``--device`` (0); ``--device-cpu`` runs on the CPU instead,
and without it and without a CUDA device it raises.  Not ported yet, and raising
``NotImplementedError``: ``--no-train`` (evaluation and recording),
``--gif``, ``--actor``/``--params`` (ROADMAP §1 item 8, with the renders of
item 6), and ``--track``/``--video-every``, which need ``MetricsLogger``
(item 6).
"""

from __future__ import annotations

import argparse
import functools
import sys
from pathlib import Path

import torch

from gymca_torch.agents.args import (
    Args,
    EnvArgs,
    ExperimentArgs,
    PPOArgs,
    VisualizationArgs,
)

__all__ = ["parse_args", "args_to_structured_args", "build_env", "train", "main"]

DEFAULT_UPDATES = 10_000_000
DEFAULT_MS_FRAME = 80


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a PPO agent on the cellular-automata envs of gymca_torch")
    env = parser.add_argument_group("Environment")
    env.add_argument("--env-id", type=str, default="advanced_bulldozer")
    env.add_argument("--num-envs", "-n", type=int, default=8)
    env.add_argument("--size", "-z", type=int, default=256)
    env.add_argument("--speed-move", "-m", type=float, default=0.12)
    env.add_argument("--speed-multiplier", type=float, default=1.0)
    env.add_argument("--no-hidden", action="store_true")
    env.add_argument("--enable-extensions", action="store_true")
    env.add_argument("--pallas-ca", action="store_true",
                     help="force the fused CUDA CA kernel on (its plain version on the CPU)")
    env.add_argument("--no-pallas-ca", action="store_true",
                     help="force the bit-reproducible XLA-path counterpart")
    env.add_argument("--conv-count", type=int, default=3)
    env.add_argument("--maxpool-count", type=int, default=2)
    env.add_argument("--ca-repeat-mode", choices=("single", "modf"), default="single",
                     help="'single' = one CA application per step; 'modf' = classic "
                          "time-gated CA (not on the fused kernel)")

    ppo = parser.add_argument_group("PPO")
    ppo.add_argument("--learning-rate", type=float, default=2.5e-4)
    ppo.add_argument("--anneal-lr", action=argparse.BooleanOptionalAction, default=True)
    ppo.add_argument("--gamma", type=float, default=0.99)
    ppo.add_argument("--gae-lambda", type=float, default=0.95)
    ppo.add_argument("--num-minibatches", type=int, default=4)
    ppo.add_argument("--update-epochs", type=int, default=4)
    ppo.add_argument("--clip-coef", type=float, default=0.1)
    ppo.add_argument("--ent-coef", type=float, default=0.01)
    ppo.add_argument("--vf-coef", type=float, default=0.5)
    ppo.add_argument("--max-grad-norm", type=float, default=0.5)
    ppo.add_argument("--shape-tree-coef", type=float, default=0.0,
                     help="potential-based shaping: phi += c * trees_frac")
    ppo.add_argument("--shape-dist-coef", type=float, default=0.0,
                     help="potential-based shaping: phi -= c * dist(agent, fire centroid)/diag")
    ppo.add_argument("--shape-douse-coef", type=float, default=0.0,
                     help="potential-based shaping: phi += c * |doused cells with fire in "
                          "their 5x5 box|/100")
    ppo.add_argument("--kickstart-coef", type=float, default=0.0,
                     help="annealed CE toward the greedy demonstrator")
    ppo.add_argument("--kickstart-decay", type=int, default=0,
                     help="iterations over which the kickstart CE anneals (0 = whole run)")

    viz = parser.add_argument_group("Visualization")
    viz.add_argument("--gif", action="store_true")
    viz.add_argument("--duration", "-d", type=float, default=DEFAULT_MS_FRAME)
    viz.add_argument("--recording-times", type=int, default=8)
    viz.add_argument("--frames-per-recording", type=int, default=8)
    viz.add_argument("--steps", "-s", type=int, default=DEFAULT_UPDATES,
                     help="total env steps to train for (iterations = steps // "
                          "(num_envs * num_ppo_steps))")

    exp = parser.add_argument_group("Experiment")
    exp.add_argument("--exp-name", type=str, default="ppo")
    exp.add_argument("--seed", type=int, default=1)
    exp.add_argument("--track", action="store_true")
    exp.add_argument("--wandb-project", type=str, default="gymca-tpu")
    exp.add_argument("--wandb-entity", type=str, default=None)
    exp.add_argument("--device", type=int, default=0)
    exp.add_argument("--device-cpu", action="store_true",
                     help="run on the CPU instead of the card")
    exp.add_argument("--profile", "-p", action="store_true")
    exp.add_argument("--num-ppo-steps", type=int, default=128)
    exp.add_argument("--no-train", "-t", action="store_true")
    exp.add_argument("--actor", choices=("random", "scripted", "params"), default="random")
    exp.add_argument("--params", type=str)
    exp.add_argument("--description", type=str, default="")
    exp.add_argument("--bf16", action="store_true", help="bfloat16 CNN compute")
    exp.add_argument("--position-features", action="store_true",
                     help="feed normalized agent position to actor/critic")
    exp.add_argument("--centroid-features", action="store_true",
                     help="feed agent->fire-centroid offset state features")
    exp.add_argument("--bc-iters", type=int, default=0,
                     help="behavior-cloning warm-start iterations before PPO")
    exp.add_argument("--critic-warmup-iters", type=int, default=0,
                     help="PPO iterations with torso+actor frozen after BC")
    exp.add_argument("--video-every", type=int, default=0)
    exp.add_argument("--out-dir", type=str, default="outputs")
    return parser.parse_args(argv)


def args_to_structured_args(a) -> Args:
    return Args(
        ppo=PPOArgs(
            learning_rate=a.learning_rate,
            anneal_lr=a.anneal_lr,
            gamma=a.gamma,
            gae_lambda=a.gae_lambda,
            num_minibatches=a.num_minibatches,
            update_epochs=a.update_epochs,
            clip_coef=a.clip_coef,
            ent_coef=a.ent_coef,
            vf_coef=a.vf_coef,
            max_grad_norm=a.max_grad_norm,
            shape_tree_coef=a.shape_tree_coef,
            shape_dist_coef=a.shape_dist_coef,
            shape_douse_coef=a.shape_douse_coef,
            kickstart_coef=a.kickstart_coef,
            kickstart_decay_iters=a.kickstart_decay,
        ),
        env=EnvArgs(
            env_id=a.env_id,
            num_envs=a.num_envs,
            size=a.size,
            speed_move=a.speed_move,
            speed_multiplier=a.speed_multiplier,
            use_hidden=not a.no_hidden,
            enable_extensions=a.enable_extensions,
            ca_repeat_mode=a.ca_repeat_mode,
        ),
        viz=VisualizationArgs(
            gif=a.gif,
            steps=a.steps,
            duration=a.duration,
            recording_times=a.recording_times,
            frames_per_recording=a.frames_per_recording,
        ),
        exp=ExperimentArgs(
            exp_name=a.exp_name,
            seed=a.seed,
            track=a.track,
            device=a.device,
            profile=a.profile,
            total_timesteps=a.steps,
            num_ppo_steps=a.num_ppo_steps,
            no_train=a.no_train,
            params_path=a.params,
            description=a.description,
            conv_count=a.conv_count,
            maxpool_count=a.maxpool_count,
            bf16_compute=a.bf16,
            position_features=a.position_features,
            centroid_features=a.centroid_features,
            bc_iters=a.bc_iters,
            critic_warmup_iters=a.critic_warmup_iters,
            checkpoint_dir=str(Path(a.out_dir) / "checkpoints"),
            log_dir=str(Path(a.out_dir) / "runs"),
        ),
    )


def build_env(args: Args, use_fused_ca=None, device=None):
    """The port's Advanced env for ``args``; ``use_fused_ca`` None keeps the
    env's default (the fused kernel on the card)."""
    from gymca_torch import rng
    from gymca_torch.config import resolve_device
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv

    dev = resolve_device(device)
    return AdvancedForestFireBulldozerEnv(
        nrows=args.env.size,
        ncols=args.env.size,
        key=rng.key(args.exp.seed, device=dev),
        num_envs=args.env.num_envs,
        speed_move=args.env.speed_move,
        speed_multiplier=args.env.speed_multiplier,
        use_hidden=args.env.use_hidden,
        enable_extensions=args.env.enable_extensions,
        use_fused_ca=use_fused_ca,
        ca_repeat_mode=args.env.ca_repeat_mode,
        device=dev,
    )


def train(args: Args, use_fused_ca=None, device=None):
    """Build the env, train, save the final params; returns the history."""
    from gymca_torch import rng
    from gymca_torch.agents.ppo import _default_log, run_rollout_loop

    env = build_env(args, use_fused_ca, device)
    run_name = (f"{args.exp.exp_name}_lr{args.ppo.learning_rate}_s{args.exp.seed}"
                f"_z{args.env.size}_n{args.env.num_envs}")

    _, agent_state, history = run_rollout_loop(
        env, args, key=rng.key(args.exp.seed, device=env.device),
        log_fn=functools.partial(_default_log, every=10),
        device=env.device)
    out_dir = Path(args.exp.checkpoint_dir).parent
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{run_name}_params.pt"
    torch.save(agent_state.params, path)
    print(f"saved final params to {path}")
    return history


def main(argv=None):
    raw = parse_args(argv)
    left_out = [flag for flag, on in (("--no-train", raw.no_train), ("--gif", raw.gif),
                                      ("--actor", raw.actor != "random"),
                                      ("--params", raw.params is not None),
                                      ("--track", raw.track),
                                      ("--video-every", raw.video_every > 0)) if on]
    if left_out:
        raise NotImplementedError(
            f"{', '.join(left_out)}: not ported yet (evaluation, recording and the "
            f"actor choices wait for ROADMAP §1 item 8, with the renders and "
            f"MetricsLogger of item 6); this entry point trains only")
    args = args_to_structured_args(raw)
    use_fused_ca = True if raw.pallas_ca else (False if raw.no_pallas_ca else None)
    train(args, use_fused_ca, "cpu" if raw.device_cpu else f"cuda:{raw.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
