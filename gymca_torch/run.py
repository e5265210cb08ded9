"""Train or evaluate on the Advanced Bulldozer: ``scripts/run`` on the port.

    python3 -m gymca_torch.run -n 8 -z 256                 # train, on the card
    python3 -m gymca_torch.run --no-train --steps 200      # evaluate a random actor
    python3 -m gymca_torch.run --no-train --actor params --params outputs/checkpoints
    python3 -m gymca_torch.run -n 2 -z 16 --no-train --gif --steps 32 --device-cpu

Takes ``scripts/run``'s Environment, PPO, Visualization and Experiment
flags and builds the same ``Args`` (``args_to_structured_args``), then the
port's ``AdvancedForestFireBulldozerEnv``.  ``--pallas-ca`` /
``--no-pallas-ca`` set ``use_fused_ca`` (the fused CUDA kernel on the card,
or the XLA-path counterpart); neither leaves the env's default, the kernel
on the card.

Training (``train``): ``run_rollout_loop`` with metrics to stdout and to
``MetricsLogger`` (TensorBoard under ``--out-dir``/runs where the
tensorboard package is installed, wandb with ``--track`` where wandb is),
a greedy rollout recorded every ``--video-every`` iterations, checkpoints
(full state, every ``checkpoint_every`` iterations) and the final params
(``<run>_params.pt``) under ``--out-dir``.

Evaluation (``--no-train``, ``evaluate``): an actor (``--actor random``,
the key chain of ``scripts/run``'s random actor; ``scripted``, its tours;
``params``, the greedy policy of the checkpoint under ``--params``) steps
the env for ``min(--steps, 10000)`` steps.  The stepping loop
(``eval_loop``) runs on the device and hands back the rewards and, with
``--gif``, the captured frames; the host writers then compose the rich
frames (agent observation | true grid with a wind arrow | dousing map) into
one GIF per env (``save_video``, Pillow) and draw the terrain heatmaps
(matplotlib).  ``--profile`` writes a ``torch.profiler`` trace of the loop,
with the program's spans as ``gymca.<name>`` ranges.

Runs on card ``--device`` (0); ``--device-cpu`` runs on the CPU instead,
and without it and without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, NamedTuple

import numpy as np

import torch

from gymca_torch.agents.args import (
    Args,
    EnvArgs,
    ExperimentArgs,
    PPOArgs,
    VisualizationArgs,
)

__all__ = ["parse_args", "args_to_structured_args", "build_env", "train", "evaluate",
           "eval_loop", "make_actor", "scripted_actions", "compose_rich_frame",
           "save_video", "save_gif", "write_recordings", "write_terrain_maps", "main"]

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
                          "time-gated CA (with --pallas-ca it warns and runs the "
                          "XLA-path counterpart)")

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


def train(args: Args, use_fused_ca=None, device=None, video_every: int = 0):
    """Build the env, train, save the final params; returns the history."""
    from gymca_torch import rng
    from gymca_torch.agents.ppo import _default_log, run_rollout_loop
    from gymca_torch.utils.metrics import MetricsLogger

    env = build_env(args, use_fused_ca, device)
    run_name = (f"{args.exp.exp_name}_lr{args.ppo.learning_rate}_s{args.exp.seed}"
                f"_z{args.env.size}_n{args.env.num_envs}")
    flat_config = {
        **{f"ppo.{k}": v for k, v in vars(args.ppo).items()},
        **{f"env.{k}": v for k, v in vars(args.env).items()},
        **{f"exp.{k}": v for k, v in vars(args.exp).items()},
    }
    logger = MetricsLogger(log_dir=args.exp.log_dir or "runs", run_name=run_name,
                           track=args.exp.track, config=flat_config)

    def log_fn(iteration, metrics):
        logger.log(metrics["global_step"], metrics)
        _default_log(iteration, metrics, every=10)

    _, agent_state, history = run_rollout_loop(
        env, args, key=rng.key(args.exp.seed, device=env.device), log_fn=log_fn,
        video_every=video_every,
        video_fn=lambda it, frames: logger.log_video("rollout", frames,
                                                     it * args.batch_size),
        device=env.device)
    logger.close()
    out_dir = Path(args.exp.checkpoint_dir).parent
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{run_name}_params.pt"
    torch.save(agent_state.params, path)
    print(f"saved final params to {path}")
    return history


# --- evaluation: actors -----------------------------------------------------------------

# Scripted evaluation tours (scripts/run's SCRIPTED_TOURS): run-length (move,
# count) segments per grid size; the bulldozer shoots on every other step.
# Moves: 0..8 Moore directions, 4 = stay.
SCRIPTED_TOURS = {
    32: [(3, 11), (7, 8), (7, 20), (1, 16), (3, 16), (5, 16)],
    100: [(3, 44), (7, 40), (3, 35), (7, 35), (5, 35), (1, 35), (5, 1),
          (1, 1), (4, 1), (3, 37), (7, 37), (5, 37), (1, 37)],
    200: [(3, 104), (7, 110), (3, 32), (7, 32), (5, 32), (1, 32)],
}

MAX_EVAL_STEPS = 10_000


def scripted_actions(size: int, num_envs: int, steps: int) -> np.ndarray:
    """The per-size tour as a (steps, num_envs, 3) int32 action array.

    Sizes without a tour get a square sweep scaled to the grid (down, right,
    up, left); the tour ends standing still."""
    tour = SCRIPTED_TOURS.get(
        size, [(3, size // 3), (7, size // 3), (1, size // 3), (5, size // 3)])
    moves = np.concatenate([np.full(c, m, np.int32) for m, c in tour])
    if len(moves) < steps:
        moves = np.concatenate([moves, np.full(steps - len(moves), 4, np.int32)])
    moves = moves[:steps]
    shoot = (np.arange(steps) % 2 == 0).astype(np.int32)
    acts = np.stack([moves, shoot, np.zeros(steps, np.int32)], axis=1)
    return np.repeat(acts[:, None, :], num_envs, axis=1)


def make_actor(args: Args, env, actor: str = "random"):
    """``get_action(obs_grid, context) -> (N, 3) int32`` on the env's device.

    ``random``: per step a split of a key chain from ``rng.key(seed)``, moves
    ``randint(k, (n,), 0, 9)`` and shots ``randint(fold_in(k, 1), (n,), 0, 2)``,
    bit for bit with ``scripts/run``'s random actor; ``scripted``: the tour of
    :func:`scripted_actions`, copied to the device once; ``params`` (or any
    actor when ``args.exp.params_path`` is set, as in ``scripts/run``): the
    greedy policy of the latest checkpoint under ``args.exp.params_path``."""
    from gymca_torch import rng
    from gymca_torch.config import TYPE_INT

    dev = env.device
    if args.exp.params_path or actor == "params":
        from gymca_torch.agents.ppo import load_actor

        return load_actor(args.exp.params_path, env, args, device=dev)
    if actor == "scripted":
        steps = min(args.viz.steps, MAX_EVAL_STEPS)
        script = torch.as_tensor(
            scripted_actions(args.env.size, args.env.num_envs, steps), device=dev)
        t = 0

        def get_action(obs_grid, context=None):
            nonlocal t
            a = script[min(t, len(script) - 1)]
            t += 1
            return a

        return get_action
    key = rng.key(args.exp.seed, device=dev)

    def get_action(obs_grid, context=None):
        nonlocal key
        pair = rng.split(key)
        key, k = pair[0], pair[1]
        n = obs_grid.shape[0]
        moves = rng.randint(k, (n,), 0, 9)
        shoots = rng.randint(rng.fold_in(k, 1), (n,), 0, 2)
        ext = torch.zeros((n,), dtype=TYPE_INT, device=dev)
        return torch.stack([moves, shoots, ext], dim=1)

    return get_action


# --- evaluation: the stepping loop on the device ---------------------------------------


class Capture(NamedTuple):
    """One recorded step of every env, on the device: the agent's RGB
    observation and the true grid in the day palette (uint8, (N, H, W, 3)),
    the dousing map (N, H, W) and the wind index (N,)."""

    agent_rgb: torch.Tensor
    true_rgb: torch.Tensor
    dousing: torch.Tensor
    wind_index: torch.Tensor


class EvalResult(NamedTuple):
    rewards: torch.Tensor  # (steps, N) float32, each step's reward
    total_reward: torch.Tensor  # (N,) float64, summed step by step
    captures: List[Capture]


def capture_every(steps: int) -> int:
    """Steps between recorded frames: about 64 frames an evaluation."""
    return max(steps // 64, 1)


def eval_loop(env, get_action, steps: int, record: bool = False) -> EvalResult:
    """Reset ``env`` and step it ``steps`` times with ``get_action``,
    restarting terminated envs (``conditional_reset``).  Everything stays on
    the env's device and nothing waits for it; with ``record``, a
    :class:`Capture` every :func:`capture_every` steps."""
    obs, info = env.reset()
    n = env.num_envs
    total = torch.zeros(n, dtype=torch.float64, device=env.device)
    rewards, captures = [], []
    every = capture_every(steps)
    day = torch.zeros(n, dtype=torch.int32, device=env.device)
    for t in range(steps):
        actions = get_action(obs[0], obs[1])
        step_tuple = env.stateless_step(actions, obs, info)
        reward = step_tuple[1]
        rewards.append(reward)
        total += reward
        obs, _, _, _, info = env.conditional_reset(step_tuple, actions)
        if record and t % every == 0:
            pe = obs[1]["per_env_context"]
            true_rgb = env._grid_to_rgb(pe["true_grid"], day, pe["dousing_count"],
                                        obs[1]["position"])
            captures.append(Capture(obs[0].to(torch.uint8), true_rgb.to(torch.uint8),
                                    pe["dousing_count"].clone(), pe["wind_index"].clone()))
    stacked = torch.stack(rewards) if rewards else torch.zeros(0, n, device=env.device)
    return EvalResult(stacked, total, captures)


# --- evaluation: host writers ----------------------------------------------------------

# Wind arrow direction per wind_index (the terrain's WIND_THETAS order: N, NE,
# E, SE, S, SW, W, NW), as (drow, dcol) unit steps.
WIND_ARROWS = [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)]


def _stamp_wind_arrow(rgb: np.ndarray, wind_index: int) -> np.ndarray:
    """Draw the wind direction as a red pixel ray from the panel's top-left
    anchor, in place; returns ``rgb``."""
    h, w, _ = rgb.shape
    length = max(min(h, w) // 8, 4)
    r0 = c0 = length + 2
    dr, dc = WIND_ARROWS[wind_index % 8]
    for k in range(length):
        r, c = r0 + dr * k, c0 + dc * k
        if 0 <= r < h and 0 <= c < w:
            rgb[r, c] = (230, 40, 40)
    rgb[r0, c0] = (0, 0, 0)  # tail anchor
    return rgb


def compose_rich_frame(agent_rgb, true_rgb, dousing, wind_index: int) -> np.ndarray:
    """Agent observation | true grid (day palette, wind arrow) | dousing map,
    side by side, with 2-pixel white separators."""
    h = agent_rgb.shape[0]
    true_panel = _stamp_wind_arrow(true_rgb.copy(), wind_index)
    dous_panel = (0.25 * true_rgb + 0.75 * 255.0).astype(np.uint8)
    dous_panel[dousing > 0] = (30, 90, 220)
    sep = np.full((h, 2, 3), 255, np.uint8)
    return np.concatenate([agent_rgb, sep, true_panel, sep, dous_panel], axis=1)


def save_gif(frames, path: Path, duration_ms: float):
    """(T, H, W, 3) uint8 frames -> an animated GIF scaled 4x (Pillow)."""
    from PIL import Image

    imgs = [Image.fromarray(f).resize((f.shape[1] * 4, f.shape[0] * 4), Image.NEAREST)
            for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=duration_ms,
                 loop=0)


def save_video(frames, path: Path, duration_ms: float) -> Path:
    """One env's recording: an mp4 through moviepy where it is installed,
    else an animated GIF."""
    try:
        from moviepy.editor import ImageSequenceClip
    except ImportError:
        gif = path.with_suffix(".gif")
        save_gif(frames, gif, duration_ms)
        return gif
    big = np.repeat(np.repeat(frames, 4, axis=1), 4, axis=2)
    clip = ImageSequenceClip(list(big), fps=max(1000.0 / duration_ms, 1))
    mp4 = path.with_suffix(".mp4")
    clip.write_videofile(str(mp4), logger=None)
    return mp4


def rich_frames(captures: List[Capture]) -> List[np.ndarray]:
    """Each env's (T, H, 3W + 4, 3) rich frames from the captures, the
    tensors copied to the host once."""
    if not captures:
        return []
    host = [np.stack([getattr(c, f).cpu().numpy() for c in captures])
            for f in Capture._fields]
    agent, true, dous, wind = host
    return [np.stack([compose_rich_frame(agent[t, i], true[t, i], dous[t, i],
                                         int(wind[t, i])) for t in range(len(captures))])
            for i in range(agent.shape[1])]


def write_recordings(captures: List[Capture], out_dir: Path, duration_ms: float):
    """One recording per env (``env<i>.gif``, or ``.mp4``), written by a pool
    of threads (the encoders release the GIL); returns the paths."""
    jobs = [(frames, out_dir / f"env{i}", duration_ms)
            for i, frames in enumerate(rich_frames(captures))]
    if len(jobs) > 1:
        from multiprocessing.dummy import Pool
        from os import cpu_count

        with Pool(min(len(jobs), cpu_count() or 1)) as pool:
            return pool.starmap(save_video, jobs)
    return [save_video(*j) for j in jobs]


def write_terrain_maps(env, out_dir: Path) -> List[Path]:
    """The terrain heatmaps of every env, ``terrain_<name>_env<i>.png``."""
    import matplotlib.pyplot as plt

    written = []
    for name, figs in [("altitude", env.altitude_render()),
                       ("density", env.density_render()),
                       ("vegitation", env.vegitation_render())]:
        for i, fig in enumerate(figs):
            path = out_dir / f"terrain_{name}_env{i}.png"
            fig.savefig(path, dpi=100)
            plt.close(fig)
            written.append(path)
    return written


def evaluate(args: Args, use_fused_ca=None, device=None, actor: str = "random",
             env=None) -> EvalResult:
    """``--no-train``: step an actor through the env, then write the
    recordings (``--gif``) and the terrain heatmaps under ``--out-dir``.

    The heatmaps need matplotlib and the recordings Pillow: where matplotlib
    is missing (the card's machine may lack it) the heatmaps are skipped with
    a note; ``--gif`` without Pillow raises before the loop starts."""
    import importlib.util

    from gymca_torch.utils.metrics import profile_trace

    if args.viz.gif and importlib.util.find_spec("PIL") is None:
        raise ImportError("--gif writes GIFs through Pillow, which is not installed")
    env = env if env is not None else build_env(args, use_fused_ca, device)
    out_dir = Path(args.exp.checkpoint_dir).parent
    out_dir.mkdir(parents=True, exist_ok=True)
    get_action = make_actor(args, env, actor)
    steps = min(args.viz.steps, MAX_EVAL_STEPS)

    with profile_trace(args.exp.profile, str(out_dir / "profile")):
        result = eval_loop(env, get_action, steps, record=args.viz.gif)
    print(f"eval: {steps} steps, mean reward/env: {result.total_reward.mean().item():.3f}")

    if args.viz.gif:
        written = write_recordings(result.captures, out_dir, args.viz.duration)
        kinds = {p.suffix for p in written}
        print(f"wrote {len(written)} recordings ({'/'.join(sorted(kinds))}) to {out_dir}")
    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed: terrain maps not written")
    else:
        write_terrain_maps(env, out_dir)
        print(f"wrote terrain maps to {out_dir}")
    return result


def main(argv=None):
    raw = parse_args(argv)
    if raw.actor == "params" and not raw.params:
        sys.exit("--actor params requires --params <checkpoint dir>")
    args = args_to_structured_args(raw)
    use_fused_ca = True if raw.pallas_ca else (False if raw.no_pallas_ca else None)
    device = "cpu" if raw.device_cpu else f"cuda:{raw.device}"
    if args.exp.no_train:
        evaluate(args, use_fused_ca, device, raw.actor)
    else:
        train(args, use_fused_ca, device, raw.video_every)
    return 0


if __name__ == "__main__":
    sys.exit(main())
