"""Metrics: TensorBoard, optional wandb, and a profiler trace.

Counterpart of ``gymca_tpu/utils/metrics.py``: ``MetricsLogger`` writes
TensorBoard scalars through ``torch.utils.tensorboard`` (stdout only where
the tensorboard package is missing) and mirrors to wandb where it can be
imported; ``profile_trace`` records a ``torch.profiler`` Chrome trace in
place of ``jax.profiler.trace``.  All host-side: the trainer hands over one
metrics dict of Python numbers per iteration, so logging adds no device
sync.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

__all__ = ["MetricsLogger", "profile_trace"]


class MetricsLogger:
    """TensorBoard scalars under ``log_dir/run_name``; mirrors to wandb when
    ``track=True`` and wandb can be imported."""

    def __init__(
        self,
        log_dir: str = "runs",
        run_name: Optional[str] = None,
        track: bool = False,
        config: Optional[dict] = None,
        wandb_project: str = "gymca-torch",
        wandb_entity: Optional[str] = None,
    ):
        self.run_name = run_name or f"run_{int(time.time())}"
        self._writer = None
        self._wandb = None

        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(f"{log_dir}/{self.run_name}")
            if config:
                hp = "|param|value|\n|-|-|\n" + "\n".join(
                    f"|{k}|{v}|" for k, v in sorted(config.items())
                )
                self._writer.add_text("hyperparameters", hp)
        except ImportError:  # no tensorboard package: stdout only
            self._writer = None

        if track:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(
                    project=wandb_project,
                    entity=wandb_entity,
                    name=self.run_name,
                    config=config,
                    sync_tensorboard=self._writer is not None,
                )
            except ImportError:
                self._wandb = None

    def log(self, step: int, metrics: dict) -> None:
        if self._writer is not None:
            for k, v in metrics.items():
                try:
                    self._writer.add_scalar(k, float(v), step)
                except (TypeError, ValueError):
                    pass
        if self._wandb is not None and self._writer is None:
            self._wandb.log(metrics, step=step)

    def log_video(self, tag: str, frames, step: int, fps: int = 4) -> None:
        """frames: (T, H, W, 3) uint8.  TensorBoard video when moviepy is
        available, else an animated GIF next to the run's event files."""
        import numpy as np

        frames = np.asarray(frames)
        if self._writer is not None:
            try:
                import moviepy  # noqa: F401 — add_video degrades silently without it
                import torch

                vid = torch.from_numpy(frames[None].transpose(0, 1, 4, 2, 3))
                self._writer.add_video(tag, vid, step, fps=fps)
                return
            except ImportError:  # moviepy missing: GIF fallback below
                pass
            from pathlib import Path

            from PIL import Image

            out = Path(self._writer.log_dir) / f"{tag}_{step}.gif"
            imgs = [Image.fromarray(f) for f in frames]
            imgs[0].save(out, save_all=True, append_images=imgs[1:],
                         duration=int(1000 / fps), loop=0)
        elif self._wandb is not None:
            self._wandb.log(
                {tag: self._wandb.Video(frames.transpose(0, 3, 1, 2), fps=fps)},
                step=step,
            )

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
        if self._wandb is not None:
            self._wandb.finish()


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(enabled: bool, logdir: str = "./profile"):
    """``torch.profiler`` trace of the enclosed block, the host's and, where
    there is one, the card's, written to ``logdir/trace.json`` (Chrome trace
    format, which Perfetto reads).  No-op when disabled."""
    if not enabled:
        yield
        return
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / TRACE_FILE))
