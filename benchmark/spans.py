"""The program's spans over one profiler session: which of them launched each
device kernel, and which held the host in each idle gap.

With its spans on (``gymca_torch.utils.metrics.enable``), each span of the
program opens a ``record_function`` named ``gymca.<name>`` inside a
profiler session.  :class:`SpanTrace` is :class:`benchmark.trace.Trace`
over the same events, its ``kernels``, ``busy_s``, ``by_name`` and
``window_s`` computed by the same code, with three readings more:

- ``span_kernels``: the kernels (copies and fills left out, as
  ``kernels``) by the innermost program span open when the host launched
  each.  The launch is the CUDA API call (``cudaLaunchKernel``,
  ``cuLaunchKernel``) that shares the kernel's correlation id (a kernel
  launched through ``ctypes``, as K1 and K2 are, has no other); failing
  that, the torch operation the profiler links the kernel to
  (``linked_correlation_id``).  A kernel with neither
  counts under :data:`UNATTRIBUTED`, one launched outside every program
  span under :data:`OUTSIDE`.  The counts sum to ``kernels``.
- ``span_idle_s``: the seconds of the idle gaps between device events by
  the innermost program span open at each gap's midpoint (the rule that
  names the gaps), :data:`OUTSIDE` where none was.
- ``gaps`` names each gap ``bench.<call> / gymca.<span> / aten::<op>``,
  the middle part left out where no program span was open.

A program without spans (before they were added, or with them off) reads
everything under :data:`OUTSIDE` and names its gaps as ``Trace`` does.
"""

from __future__ import annotations

import bisect

from benchmark.trace import NOT_KERNELS, Trace

PREFIX = "gymca."
OUTSIDE = "outside the program's spans"
UNATTRIBUTED = "unattributed"
# Host events of CUDA API calls (cudaLaunchKernel, cuLaunchKernel): their ids
# are CUDA's, as a kernel's own; a kernel's link names a torch operation's.
RUNTIME = "cu"


class Innermost:
    """The innermost of properly nested ``(start, end, name)`` intervals at
    a time: the intervals cut into flat segments, looked up by bisection."""

    def __init__(self, intervals):
        self.times, self.names = [], []
        open_ = []  # (end, name), innermost last
        for s, e, n in sorted(intervals, key=lambda x: (x[0], -x[1])):
            self._close_until(open_, s)
            self.times.append(s)
            self.names.append(n)
            open_.append((e, n))
        self._close_until(open_, None)

    def _close_until(self, open_, t):
        while open_ and (t is None or open_[-1][0] <= t):
            end = open_.pop()[0]
            self.times.append(end)
            self.names.append(open_[-1][1] if open_ else None)

    def at(self, t):
        """The name of the innermost interval holding ``t`` (its start in,
        its end out), None if none does."""
        i = bisect.bisect_right(self.times, t) - 1
        return self.names[i] if i >= 0 else None


class SpanTrace(Trace):
    def __init__(self, events, window_s: float):
        from torch.autograd import DeviceType

        annotations, launches, ops, kernels = [], {}, {}, []
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation() and not e.name().startswith(NOT_KERNELS):
                    kernels.append((e.correlation_id(), e.linked_correlation_id()))
            elif e.name().startswith(RUNTIME):
                launches[e.correlation_id()] = e.start_ns()
            elif e.linked_correlation_id() == 0:  # a torch operation or a record_function
                ops[e.correlation_id()] = e.start_ns()
                if e.is_user_annotation() and e.name().startswith(PREFIX):
                    annotations.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        self.program = Innermost(annotations)
        self.span_idle_s = {}
        super().__init__(events, window_s)  # names the gaps through _name_gaps below
        self.span_kernels = {}
        for corr, link in kernels:
            start = launches.get(corr)
            if start is None and link:
                start = ops.get(link)
            name = UNATTRIBUTED if start is None else self._span(start)
            self.span_kernels[name] = self.span_kernels.get(name, 0) + 1

    def _span(self, t) -> str:
        name = self.program.at(t)
        return name[len(PREFIX):] if name else OUTSIDE

    def _name_gaps(self, busy, spans, ops):
        calls, top_ops = Innermost(spans), Innermost(ops)
        named = {}
        for (_, end), (nxt, _) in zip(busy, busy[1:]):
            mid, seconds = (end + nxt) // 2, (nxt - end) * 1e-9
            parts = (calls.at(mid) or "host outside the system's calls", self.program.at(mid),
                     top_ops.at(mid) or "no torch op")
            name = " / ".join(p for p in parts if p)
            named[name] = named.get(name, 0.0) + seconds
            span = self._span(mid)
            self.span_idle_s[span] = self.span_idle_s.get(span, 0.0) + seconds
        return named
