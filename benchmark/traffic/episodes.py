"""Traffic of kind ``episodes``: the generator, the driving loop and the
check of the env cells.

A traffic file (``benchmark/traffic/<mix>.json``) of this kind gives the
batch (``envs``), the episode length (``episode_steps``), the range
[low, high) of each action column (``actions``), how many envs a run
checks (``check_envs``), and for a traced run how many steps it profiles
(``trace_steps``) from which step of an episode (``trace_from``).  At each
episode's start the episode's actions are drawn, uniform in their ranges,
from a ``torch.Generator`` on the device seeded by ``--seed``, and the
system restarts from the states it made in set-up: so a step's work does
not depend on how many steps a faster program reaches.  The loop is closed:
step after step, with no synchronisation inside, each step followed by a
CUDA event.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time

import torch


def sample_envs(seed: int, envs: int, count: int):
    """The envs a run checks, drawn from the seed."""
    g = torch.Generator()
    g.manual_seed(int(seed))
    return torch.randperm(envs, generator=g)[:min(count, envs)].sort().values


def draw_actions(gen, traffic: dict, device):
    """One episode's (steps, envs, columns) int32 actions."""
    n, t = traffic["envs"], traffic["episode_steps"]
    cols = [torch.randint(lo, hi, (t, n), generator=gen, device=device, dtype=torch.int32)
            for lo, hi in traffic["actions"]]
    return torch.stack(cols, dim=-1)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


class Spans:
    """Host seconds of each call the system names, per step, recorded only
    in a traced run and only in its window (each also a
    ``record_function`` span, which names the host's work in the profiler's
    trace)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.seconds = {}  # name -> [seconds of each call in the window]
        self.recording = True

    @contextlib.contextmanager
    def _span(self, name):
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function(f"bench.{name}"):
            yield
        if self.recording:
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)

    def __call__(self, name):
        return self._span(name) if self.enabled else contextlib.nullcontext()


class Driver:
    """Drives ``system`` (a ``benchmark/envs`` module's ``System``) with
    ``traffic`` from ``seed``."""

    def __init__(self, system, traffic: dict, seed: int, device, trace: bool):
        self.system, self.traffic, self.seed, self.trace = system, traffic, int(seed), trace
        self.dev = torch.device(device)
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(self.seed)
        self.spans = Spans(trace)
        self.actions = None  # the current episode's (steps, envs, columns) actions
        self.at = 0  # steps taken in the current episode
        self.finished = None  # (state, actions) of the last episode run to its end

    def _draw(self):
        return draw_actions(self.gen, self.traffic, self.dev)

    def _restart(self):
        if self.at == self.traffic["episode_steps"]:
            self.finished = (self.system.state(), self.actions)
        actions = self._draw()
        with self.spans("restart"):
            self.actions = actions
            self.system.restart()
        self.at = 0

    def _step(self, record=None):
        if self.at == self.traffic["episode_steps"]:
            self._restart()
        if record is not None:  # what a traced step's work count reads
            record.append((self.system.work_inputs(), self.actions[self.at]))
        self.system.step(self.actions[self.at], self.spans)
        self.at += 1

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def warm(self):
        """Set-up: every shape the window uses, an episode start included."""
        self._restart()
        for _ in range(3):
            self._step()
        self._sync()

    def window(self, seconds: float, max_steps=None) -> dict:
        """Steps for ``seconds`` (or exactly ``max_steps``) from an episode
        start; a traced run then profiles the same steps of an episode
        whatever its window reached."""
        cuda = self.dev.type == "cuda"
        events, ends = [], []
        self.spans.seconds = {}  # the warm-up's calls are set-up
        self.finished = None
        gc.freeze()  # the set-up's objects stay out of the collector's scans in the window
        self._restart()
        steps = 0
        t0 = time.perf_counter()
        while True:
            self._step()
            steps += 1
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
            ends.append(time.perf_counter())
            if steps >= max_steps if max_steps is not None else ends[-1] - t0 >= seconds:
                break
        self._sync()
        window_s = time.perf_counter() - t0
        checked = self.checked()
        session, traced = self._profile() if self.trace else (None, [])
        self.finished = checked
        gaps = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        n = self.traffic["envs"]
        tenth = max(len(ends) // 10, 1)
        print(f"[benchmark] window {window_s:.3f} s, {steps} steps of {n} envs; host ms a step "
              f"in its first and last tenths {1e3 * (ends[tenth - 1] - t0) / tenth:.3f}, "
              f"{1e3 * (ends[-1] - ends[-tenth - 1]) / tenth:.3f}", file=sys.stderr, flush=True)
        return {"steps": steps, "envs": n, "attempted": n * steps, "window_s": window_s,
                "step_gaps_ms": gaps, "spans": self.spans.seconds,
                "trace": session.trace if session is not None else None, "traced": traced}

    def _profile(self):
        """A profiler session over ``trace_steps`` steps from step
        ``trace_from`` of an episode whose actions are the seed's first
        draw: the same steps in every run of the seed.  The steps before it
        are untimed."""
        from benchmark.trace import Session

        self.spans.recording = False
        self.gen.manual_seed(self.seed)
        self.at = 0
        self._restart()
        for _ in range(self.traffic["trace_from"]):
            self._step()
        self._sync()
        traced = []
        with Session(self.dev) as session:
            for _ in range(self.traffic["trace_steps"]):
                self._step(traced)
        return session, traced

    def checked(self):
        """The episode a run checks: the last one of the window run to its
        end, else the one running at the window's close, as (the system's
        state at its end, its actions)."""
        if self.finished is not None:
            return self.finished
        return self.system.state(), self.actions[:self.at]

    def check(self, ref) -> dict:
        """After the window: the program's answers for a sample of envs drawn
        from the seed, then, with the program's state freed, the reference
        ``ref`` (a ``benchmark/reference`` module) replaying the checked
        episode from the seed; the compared numbers by name."""
        n = self.traffic["envs"]
        idx = sample_envs(self.seed, n, self.traffic["check_envs"])
        state, actions = self.checked()
        start = _clone(self.system.start(idx))
        end = _clone(self.system.answers(idx, state, actions))
        actions, inputs, cfg = actions.clone(), self.system.inputs, self.system.cfg
        del state
        self.system = self.finished = self.actions = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        start_ref, end_ref = ref.replay(cfg, self.seed, n, idx, actions, self.dev, **inputs)
        print(f"[benchmark] reference: {len(actions)} steps of {len(idx)} envs in "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
        return ref.check(start, start_ref, end, end_ref)
