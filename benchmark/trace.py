"""One profiler session over a traced run's profiled steps, reduced to the
numbers the per-layer metrics read.

The device's events are read straight from the profiler's kineto results
(no per-event Python objects are built for the whole session): busy time
is the union of the device events' intervals, the idle gaps are the holes
between them, each named by the benchmark's ``record_function`` span
(``bench.<call>``) and the top-level torch operation the host was in at
the gap's middle.
"""

from __future__ import annotations

import bisect
import time

import torch

NOT_KERNELS = ("Memcpy", "Memset")
TOP = 10  # entries of each breakdown list


class Session:
    """``with Session(device) as s: ...`` profiles the block; ``s.trace``
    is its :class:`Trace`, ``None`` off a card."""

    def __init__(self, device):
        self.dev = torch.device(device)
        self.prof = None
        self.trace = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if self.dev.type == "cuda":
            self.trace = Trace(self.prof.profiler.kineto_results.events(), window_s)
        return False


def _union(spans):
    """Merged, sorted (start, end) intervals."""
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Trace:
    def __init__(self, events, window_s: float):
        from torch.autograd import DeviceType

        self.window_s = window_s
        device, spans, ops = [], [], []
        for e in events:
            if e.is_user_annotation():
                if e.device_type() == DeviceType.CPU and e.name().startswith("bench."):
                    spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            elif e.device_type() == DeviceType.CUDA:
                device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            elif e.name().startswith("aten::"):
                ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        self.kernels = sum(1 for _, _, n in device if not n.startswith(NOT_KERNELS))
        self.by_name = {}
        for s, e, n in device:
            total, count = self.by_name.get(n, (0.0, 0))
            self.by_name[n] = (total + (e - s) * 1e-9, count + 1)
        busy = _union((s, e) for s, e, _ in device)
        self.busy_s = sum(e - s for s, e in busy) * 1e-9
        self.gaps = self._name_gaps(busy, sorted(spans), self._top_level(ops))

    @staticmethod
    def _top_level(ops):
        top, end = [], -1
        for s, e, n in sorted(ops):
            if s >= end:
                top.append((s, e, n))
                end = e
        return top

    @staticmethod
    def _name_gaps(busy, spans, ops):
        starts = [s for s, _, _ in spans]
        op_starts = [s for s, _, _ in ops]
        named = {}
        for (_, end), (nxt, _) in zip(busy, busy[1:]):
            mid = (end + nxt) // 2
            span = "host outside the system's calls"
            i = bisect.bisect_right(starts, mid) - 1
            for k in range(i, max(i - 4, -1), -1):  # spans nest a few deep at most
                if spans[k][1] >= mid:  # the innermost span holding mid started last
                    span = spans[k][2]
                    break
            j = bisect.bisect_right(op_starts, mid) - 1
            op = ops[j][2] if j >= 0 and ops[j][1] >= mid else "no torch op"
            name = f"{span} / {op}"
            named[name] = named.get(name, 0.0) + (nxt - end) * 1e-9
        return named

    def kernel_seconds(self, names, launches: int):
        """Device seconds of ``launches`` launches of each kernel whose name
        holds one of ``names``: each kernel's mean event times the launches
        (a session can lose a few events), None if one of ``names`` shows no
        event."""
        total = 0.0
        for part in names:
            hits = [(t, c) for n, (t, c) in self.by_name.items() if part in n]
            if not hits:
                return None
            t, c = sum(h[0] for h in hits), sum(h[1] for h in hits)
            total += t / c * max(launches, c)
        return total

    def breakdown(self) -> dict:
        ops = sorted(((n, t) for n, (t, _) in self.by_name.items()), key=lambda x: -x[1])
        gaps = sorted(self.gaps.items(), key=lambda x: -x[1])
        return {"device_ops": [[n[:160], t] for n, t in ops[:TOP]],
                "idle_gaps": [[n[:160], t] for n, t in gaps[:TOP]]}
