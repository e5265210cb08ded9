"""One profiler session over a PPO iteration, read by the program's spans.

:class:`IterationTrace` is :class:`benchmark.spans.SpanTrace` (each kernel
under the innermost program span open at its launch, the idle gaps by the
span at their midpoint) with one reading more: ``root_busy_s``, the
device-busy seconds (the union of their intervals) of the kernels launched
inside each outermost program span, at any depth below it; an iteration's
are ``rollout``, ``gae`` and ``update``.  A kernel is placed by its launch
as ``SpanTrace`` places it; one with no launch, or launched outside every
program span, counts under no root.
"""

from __future__ import annotations

import bisect
import time

import torch

from benchmark.spans import PREFIX, RUNTIME, SpanTrace
from benchmark.trace import NOT_KERNELS, Session, _union


def outermost(intervals):
    """The ``(start, end, name)`` intervals no other holds, sorted."""
    roots = []
    for s, e, n in sorted(intervals, key=lambda x: (x[0], -x[1])):
        if not roots or s >= roots[-1][1]:
            roots.append((s, e, n))
    return roots


class IterationTrace(SpanTrace):
    def __init__(self, events, window_s: float):
        from torch.autograd import DeviceType

        annotations, launches, ops, kernels = [], {}, {}, []
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation() and not e.name().startswith(NOT_KERNELS):
                    kernels.append((e.correlation_id(), e.linked_correlation_id(),
                                    e.start_ns(), e.start_ns() + e.duration_ns()))
            elif e.name().startswith(RUNTIME):
                launches[e.correlation_id()] = e.start_ns()
            elif e.linked_correlation_id() == 0:
                ops[e.correlation_id()] = e.start_ns()
                if e.is_user_annotation() and e.name().startswith(PREFIX):
                    annotations.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                        e.name()[len(PREFIX):]))
        roots = outermost(annotations)
        starts = [s for s, _, _ in roots]
        by_root = {}
        for corr, link, start, end in kernels:
            t = launches.get(corr)
            if t is None and link:
                t = ops.get(link)
            i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
            if i >= 0 and t < roots[i][1]:
                by_root.setdefault(roots[i][2], []).append((start, end))
        self.root_busy_s = {name: sum(e - s for s, e in _union(spans)) * 1e-9
                            for name, spans in by_root.items()}
        super().__init__(events, window_s)


class IterationSession(Session):
    """:class:`benchmark.trace.Session` whose ``trace`` is an
    :class:`IterationTrace`."""

    def __exit__(self, *exc):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if self.dev.type == "cuda":
            self.trace = IterationTrace(self.prof.profiler.kineto_results.events(), window_s)
        return False
