"""The program's spans read over a profiler session (``benchmark/spans.py``)
from synthetic kineto events, and a toy traced run with the spans on."""

import pytest
from torch.autograd import DeviceType

from benchmark import run as bench_run
from benchmark.spans import OUTSIDE, UNATTRIBUTED, Innermost, SpanTrace
from benchmark.tests import toy
from benchmark.trace import Trace

SEED = 2**31 + 4099


class Event:
    """The part of a kineto event the traces read."""

    def __init__(self, name, start, end, kind="cpu_op", corr=0, link=0):
        self._name, self._start, self._end = name, start, end
        self.kind, self.corr, self.link = kind, corr, link

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        return DeviceType.CUDA if self.kind in ("kernel", "gpu_memcpy", "gpu_user_annotation") \
            else DeviceType.CPU

    def is_user_annotation(self):
        return self.kind in ("user_annotation", "gpu_user_annotation")

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.link


def ann(name, start, end, corr):
    return Event(name, start, end, "user_annotation", corr)


def kernel(name, start, end, corr, link):
    return Event(name, start, end, "kernel", corr, link)


def launch(start, corr, link=0):
    return Event("cudaLaunchKernel", start, start + 2, "cuda_runtime", corr, link)


# One step_batched: two key-chain ops and K1's launch in program spans, the
# glue's torch.where, then a copy outside every span and a kernel with no
# host event.  Kernels carry CUDA's ids (900 on), torch operations theirs.
BENCH = [ann("bench.step_batched", 0, 1000, 1)]
PROGRAM = [ann("gymca.step_batched", 10, 990, 2), ann("gymca.rng", 20, 300, 3),
           ann("gymca.ca", 400, 500, 4)]
HOST = [Event("aten::__and__", 30, 60, corr=11), Event("aten::add", 100, 130, corr=12),
        Event("aten::where", 600, 620, corr=14), Event("aten::copy_", 1100, 1120, corr=15),
        launch(32, 901, 11), launch(420, 903),  # K1 through ctypes: no torch op around it
        launch(605, 904, 14),
        # a runtime call whose CUDA id equals aten::add's: not its host event
        Event("cudaStreamSynchronize", 5000, 5010, "cuda_runtime", corr=12)]
DEVICE = [kernel("and_kernel", 40, 70, 901, 11), kernel("add_kernel", 110, 140, 902, 12),
          kernel("windy_band_kernel", 450, 480, 903, 0),
          kernel("where_kernel", 610, 640, 904, 14),
          Event("Memcpy DtoD", 700, 720, "gpu_memcpy", 905, 0),
          kernel("copy_kernel", 1110, 1130, 906, 15), kernel("lost_kernel", 1200, 1210, 907, 0)]
DEVICE_SPANS = [Event("gymca.rng", 40, 140, "gpu_user_annotation")]
EVENTS = BENCH + PROGRAM + HOST + DEVICE + DEVICE_SPANS
WINDOW_S = 2e-6


def test_each_kernel_counts_under_the_span_that_launched_it():
    t = SpanTrace(EVENTS, WINDOW_S)
    assert t.span_kernels == {"rng": 2, "ca": 1, "step_batched": 1, OUTSIDE: 1,
                              UNATTRIBUTED: 1}
    assert sum(t.span_kernels.values()) == t.kernels == 6


def test_idle_gaps_count_under_the_span_at_their_midpoint():
    t = SpanTrace(EVENTS, WINDOW_S)
    assert t.span_idle_s == pytest.approx({"rng": 40e-9 + 310e-9,
                                           "step_batched": 130e-9 + 60e-9 + 390e-9,
                                           OUTSIDE: 70e-9})
    assert sum(t.span_idle_s.values()) == pytest.approx(WINDOW_S - t.busy_s - 40e-9 - 790e-9)
    assert t.gaps == pytest.approx({
        "bench.step_batched / gymca.rng / no torch op": 350e-9,
        "bench.step_batched / gymca.step_batched / no torch op": 580e-9,
        "host outside the system's calls / no torch op": 70e-9})


@pytest.mark.parametrize("events", [HOST + DEVICE, BENCH + HOST + DEVICE],
                         ids=["no_calls", "calls"])
def test_program_spans_leave_the_accepted_readings_alone(events):
    """A session without program spans, CPU or device side, reads as with
    them: the same kernels, busy time, kernel times and, without the middle
    part, gap names; and SpanTrace reads as Trace there."""
    without = Trace(events, WINDOW_S)
    for t in (Trace(events + PROGRAM + DEVICE_SPANS, WINDOW_S),
              SpanTrace(events + PROGRAM + DEVICE_SPANS, WINDOW_S), SpanTrace(events, WINDOW_S)):
        assert (t.kernels, t.busy_s, t.by_name, t.window_s) == (
            without.kernels, without.busy_s, without.by_name, without.window_s)
        gaps = {}
        for name, s in t.gaps.items():
            name = " / ".join(p for p in name.split(" / ") if not p.startswith("gymca."))
            gaps[name] = gaps.get(name, 0.0) + s
        assert gaps == pytest.approx(without.gaps)
    plain = SpanTrace(events, WINDOW_S)
    assert plain.gaps == without.gaps
    assert set(plain.span_kernels) <= {OUTSIDE, UNATTRIBUTED}
    assert set(plain.span_idle_s) == {OUTSIDE}


def test_the_innermost_interval():
    inner = Innermost([(0, 100, "a"), (10, 20, "b"), (20, 30, "c"), (25, 28, "d"),
                       (40, 100, "e"), (40, 50, "f")])
    expect = {-1: None, 0: "a", 15: "b", 20: "c", 26: "d", 28: "c", 35: "a", 40: "f",
              50: "e", 99: "e", 100: None}
    assert {t: inner.at(t) for t in expect} == expect


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return bench_run.Spec(toy.build(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell,paths", [
    ("bulldozer-toy", {"step_batched", "step_batched/rng", "step_batched/ca"}),
    ("advanced-toy", {"stateless_step", "stateless_step/rng", "stateless_step/ca",
                      "stateless_step/observe", "conditional_reset", "conditional_reset/rng",
                      "conditional_reset/fresh_state", "conditional_reset/fresh_state/rng",
                      "conditional_reset/observe"})])
def test_a_traced_run_with_the_programs_spans_on(spec, cell, paths):
    from gymca_torch.utils import metrics

    metrics.reset()
    metrics.enable()
    try:
        r = bench_run.run_cell(spec, cell, SEED, 0, True, "cpu", max_steps=30)
    finally:
        metrics.disable()
    snap = metrics.snapshot()
    metrics.reset()
    assert r["correct"], r["checks"]
    assert paths <= set(snap)
    steps = 30 + 3 + 5 + 3  # window, warm-up, the steps to the traced ones, the traced ones
    assert all(snap[p][0] >= steps for p in paths if p.count("/") == 0)
