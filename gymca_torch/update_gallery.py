"""Render a gallery of the port's registered envs: ``scripts/update_gallery``
on the port.

    python3 -m gymca_torch.update_gallery [--out-dir pics/torch] [--steps 64] [--seed 1] \\
        [--fmt svg|png] [--device-cpu]

For each id of ``gymca_torch.gymca.envs``: ``gym.make`` the env (on the card
unless ``--device-cpu``), reset it with ``--seed``, play ``--steps`` random
actions (``action_space.sample()``, a reset when an episode ends) and save
its ``render()`` as ``<id>.<fmt>``, the id's last part with ``-`` turned to
``_`` (``ForestFireBulldozer256x256_v3.svg``), as the script names them.
The default directory is ``pics/torch``: ``pics/`` holds the JAX package's
gallery.  Needs gymnasium and matplotlib (Agg), imported when it runs.
"""

from __future__ import annotations

import argparse
from pathlib import Path

__all__ = ["parse_args", "file_name", "main"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Render a gallery of the registered envs")
    ap.add_argument("--out-dir", type=str, default="pics/torch")
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--fmt", type=str, default="svg", choices=["svg", "png"])
    ap.add_argument("--device-cpu", action="store_true", help="run the envs on the CPU")
    return ap.parse_args(argv)


def file_name(env_id: str, fmt: str) -> str:
    """``gymca_torch:gymca_torch/ForestFireHelicopter42x42-v1`` ->
    ``ForestFireHelicopter42x42_v1.<fmt>``."""
    return env_id.split(":")[-1].split("/")[-1].replace("-", "_") + "." + fmt


def main(argv=None) -> list:
    """Writes one render per env; returns the paths written."""
    import matplotlib

    matplotlib.use("Agg")
    import gymnasium as gym
    import matplotlib.pyplot as plt

    import gymca_torch

    a = parse_args(argv)
    kwargs = {"device": "cpu"} if a.device_cpu else {}
    out = Path(a.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for env_id in gymca_torch.gymca.envs:
        env = gym.make(env_id, **kwargs)
        env.reset(seed=a.seed)
        for _ in range(a.steps):
            _, _, done, _, _ = env.step(env.action_space.sample())[:5]
            if done:
                env.reset()
        fig = env.unwrapped.render()
        path = out / file_name(env_id, a.fmt)
        fig.savefig(path, bbox_inches="tight")
        print(f"wrote {path}", flush=True)
        plt.close(fig)
        written.append(path)
    return written


if __name__ == "__main__":
    main()
