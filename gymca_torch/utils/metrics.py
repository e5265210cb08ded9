"""Metrics: TensorBoard, optional wandb, a profiler trace and the program's
spans.

Counterpart of ``gymca_tpu/utils/metrics.py``: ``MetricsLogger`` writes
TensorBoard scalars through ``torch.utils.tensorboard`` (stdout only where
the tensorboard package is missing) and mirrors to wandb where it can be
imported; ``profile_trace`` records a ``torch.profiler`` Chrome trace in
place of ``jax.profiler.trace``.  All host-side: the trainer hands over one
metrics dict of Python numbers per iteration, so logging adds no device
sync.

``span(name)`` marks a layer of the program (the env entry points, the key
chain, the CA launch, the fresh states, the observation; the trainer's
rollout, policy, GAE, update, loss and gradients, optimizer).  Spans are off
unless :func:`enable` turned them on; an off span costs one test of a
module flag.  On, each span counts its calls and host nanoseconds in memory
under the path of the program spans enclosing it (``snapshot()``), and
inside a ``torch.profiler`` session it is also a ``record_function`` named
``gymca.<name>``, on the clock of the device's events.  Spans assume the
program steps its envs from one thread.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Optional

import torch.autograd.profiler as _autograd_profiler

__all__ = ["MetricsLogger", "profile_trace", "span", "enable", "disable", "reset",
           "snapshot", "SPAN_PREFIX"]


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
    format, which Perfetto reads), with the program's spans on: each shows
    as a ``gymca.<name>`` range.  No-op when disabled."""
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
    was_on = _on
    enable()
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        if not was_on:
            disable()
    prof.export_chrome_trace(str(out / TRACE_FILE))


SPAN_PREFIX = "gymca."

_on = False  # the one test an off span makes
# Open spans, innermost last: [name, path, start ns, child ns, nested, record_function].
_stack = []
_stats = {}  # path -> [calls, total ns, child ns]


def enable() -> None:
    """Spans on: they count from the next span opened.  Turn them on and off
    outside any open span."""
    global _on
    _on = True


def disable() -> None:
    """Spans off; the counts stay until :func:`reset`."""
    global _on
    _on = False


def reset() -> None:
    """Drops the counts (spans open now still count when they close)."""
    _stats.clear()


def snapshot() -> dict:
    """``{path: (calls, total_ns, child_ns)}`` of every span closed while on;
    ``path`` joins the names of the enclosing spans with ``/``
    (``conditional_reset/fresh_state/rng``).  A span's self time is
    ``total_ns - child_ns``."""
    return {path: tuple(s) for path, s in _stats.items()}


def _open(name: str) -> None:
    for frame in reversed(_stack):
        if frame[0] == name:  # inside a span of its own name: counts as that one
            frame[4] += 1
            return
    path = f"{_stack[-1][1]}/{name}" if _stack else name
    start = time.perf_counter_ns()
    rf = None
    if _autograd_profiler._is_profiler_enabled:
        rf = _autograd_profiler.record_function(SPAN_PREFIX + name)
        rf.__enter__()
    _stack.append([name, path, start, 0, 0, rf])


def _close(name: str) -> None:
    for i in range(len(_stack) - 1, -1, -1):
        if _stack[i][0] == name:
            break
    else:  # opened while spans were off
        return
    frame = _stack[i]
    if frame[4]:
        frame[4] -= 1
        return
    del _stack[i:]
    if frame[5] is not None:
        frame[5].__exit__(None, None, None)
    total = time.perf_counter_ns() - frame[2]
    stats = _stats.get(frame[1])
    if stats is None:
        stats = _stats[frame[1]] = [0, 0, 0]
    stats[0] += 1
    stats[1] += total
    stats[2] += frame[3]
    if _stack:
        _stack[-1][3] += total


class _Span:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _on:
            _open(self.name)
        return self

    def __exit__(self, *exc):
        if _stack:
            _close(self.name)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            _open(name)
            try:
                return fn(*args, **kwargs)
            finally:
                _close(name)

        return spanned


_spans = {}


def span(name: str) -> _Span:
    """The span ``name``: ``with span(name): ...`` or ``@span(name)`` on a
    function.  A span nested in one of the same name counts nothing of its
    own (``randint``'s inner ``split`` counts as the outer ``rng``).  The
    object is made once per name, so an off ``with`` allocates nothing."""
    s = _spans.get(name)
    if s is None:
        s = _spans[name] = _Span(name)
    return s
