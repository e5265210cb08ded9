"""Traffic of kind ``ppo``: training, the driving loop and the check of the
trainer cells.

A traffic file of this kind gives the iteration's batch: ``envs``,
``rollout_steps``, ``minibatches`` and ``epochs``, which the system's
trainer must have (``System.batch``).  The loop is closed and continuous:
training goes on from the seed's initial carry, as a user's run does, each
iteration taking the carry the last one made; there is no rate, since each
iteration needs the params before it.  A step is one iteration: the
trainer's ``train_iteration`` and its one host fetch of the metrics, then a
CUDA event.  The set-up makes the initial carry and runs one iteration.

A traced run turns the program's spans on for the window
(``gymca_torch.utils.metrics``), then profiles one whole iteration from the
carry the set-up ended with: the same iteration in every run of a seed.

The check takes the last iteration the window completed, runs it again from
its input carry (``System.replay``), counts the values of the re-run's
output carry that differ from the window's, and has the reference
(``benchmark/reference/ppo.py``) read the re-run's record with the
program's state freed.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from benchmark.reference.compare import values_wrong


def leaves(tree, path=""):
    """``{path: tensor}`` of every tensor in a carry."""
    if isinstance(tree, torch.Tensor):
        return {path: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    elif hasattr(tree, "__dataclass_fields__"):
        items = ((k, getattr(tree, k)) for k in tree.__dataclass_fields__)
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(leaves(v, f"{path}/{k}"))
    return out


class Driver:
    """Trains ``system`` (``benchmark/envs/ppo.py``'s ``System``) with
    ``traffic`` from ``seed``."""

    def __init__(self, system, traffic: dict, seed: int, device, trace: bool):
        self.system, self.trace = system, trace
        self.dev = torch.device(device)
        batch = system.batch()
        wrong = {k: (traffic[k], v) for k, v in batch.items() if traffic[k] != v}
        if wrong:
            raise ValueError(f"the traffic's batch differs from the trainer's: {wrong}")
        self.samples = batch["envs"] * batch["rollout_steps"]
        self.carry = None  # the window's first carry, kept for the traced iteration
        self.checked = None  # (input carry, output carry) of the iteration checked

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def warm(self):
        """Set-up: the initial carry and one iteration from it."""
        self.carry, _ = self.system.iterate(self.system.start())
        self._sync()

    def window(self, seconds: float, max_steps=None) -> dict:
        """Iterations for ``seconds`` (or exactly ``max_steps``) from the
        set-up's carry; a traced run then profiles the window's first
        iteration again."""
        from gymca_torch.utils import metrics

        cuda = self.dev.type == "cuda"
        if self.trace:
            metrics.reset()
            metrics.enable()
        counted = self.system.counters()
        events, ends = [], []
        carry, iterations = self.carry, 0
        gc.freeze()  # the set-up's objects stay out of the collector's scans in the window
        t0 = time.perf_counter()
        while True:
            before = carry
            carry, _ = self.system.iterate(carry)
            iterations += 1
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
            ends.append(time.perf_counter())
            if (iterations >= max_steps if max_steps is not None
                    else ends[-1] - t0 >= seconds):
                break
        self._sync()
        window_s = time.perf_counter() - t0
        after = self.system.counters()
        snap = metrics.snapshot() if self.trace else {}
        self.checked = (before, carry)
        del before, carry
        session = self._profile() if self.trace else None
        metrics.disable()
        self.carry = None
        gaps = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        print(f"[benchmark] window {window_s:.3f} s, {iterations} iterations of "
              f"{self.samples} samples; host s an iteration "
              f"{', '.join(f'{b - a:.3f}' for a, b in zip([t0] + ends, ends))}",
              file=sys.stderr, flush=True)
        if snap:
            print("[benchmark] host ms an iteration by span path (calls): " + ", ".join(
                f"{path} {1e-6 * total / iterations:.1f} ({calls})"
                for path, (calls, total, _) in sorted(snap.items()) if path.count("/") < 2),
                file=sys.stderr, flush=True)
        trace = session.trace if session is not None else None
        if trace is not None:
            print(f"[benchmark] traced iteration: kernels {trace.kernels} by span "
                  f"{trace.span_kernels}; busy s by root span {trace.root_busy_s}",
                  file=sys.stderr, flush=True)
        counters = None if counted is None else {k: after[k] - counted[k] for k in counted}
        return {"steps": iterations, "attempted": iterations * self.samples,
                "window_s": window_s, "step_gaps_ms": gaps, "program_spans": snap,
                "counters": counters, "trace": trace}

    def _profile(self):
        from torch.profiler import record_function

        from benchmark.ppo_trace import IterationSession

        with IterationSession(self.dev) as session:
            with record_function("bench.train_iteration"):
                self.system.iterate(self.carry)
        return session

    def check(self, ref) -> dict:
        """The checked iteration run again and compared with the window's,
        then its record read by the reference ``ref``; the numbers by
        name."""
        before, window_out = self.checked
        self.checked = None
        out, record = self.system.replay(before)
        window, again = leaves(window_out), leaves(out)
        rerun_wrong = (values_wrong(again, window, list(window)) if again.keys() == window.keys()
                       else sum(t.numel() for t in window.values()))
        cfg, terrain = self.system.cfg, self.system.inputs["terrain"]
        del before, window_out, out, window, again
        self.system = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        numbers = ref.check(cfg, record, terrain, self.dev)
        print(f"[benchmark] reference: one iteration's record read in "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
        return dict(numbers, rerun_values_wrong=rerun_wrong)
