"""Timing of the port's kernels on the card.

A kernel's time is read from the profiler's CUDA kernel events: the
kernel's own time on the card.  CUDA events around a Python loop of wrapper
calls read the host instead, because each wrapper's checks make the card
wait for the next launch (K1's idle floor read 24-44 µs that way and 4.81 µs
from the kernel events on an H100).  :func:`time_launches` is the one
policy for a kernel's time: host time per launch is the host clock to a
``torch.cuda.synchronize()``, the best of a few repetitions; device time
per launch is the median over the repetitions of the sum of each device
kernel's mean, each repetition in a profiler session of its own.  On an
H100 the profiler now and then loses some or all of a session's kernel
events, and one session in a few dozen has read half the kernel's time that
every other session read: a session in which a kernel kept fewer than half
of its launches, or more events than there were launches, is made again (up
to three times), and the median hides one session that reads short.  Each
kernel's mean is taken from its own events, so a session that loses more of
one kernel's events than another's is not biased towards the other.

A part of a step, as the step breakdowns report it
(``gymca_torch.profile_step`` and its siblings), is timed by
:func:`time_steps`: host µs a step, the best of a few runs from the same
start, each to a synchronize, and on a card the device's own numbers from
a traced run of its first ``TRACE_STEPS`` steps (:func:`profile_steps`:
device kernels and busy µs a step, the idle share of the device span, the
kernels that take most of it).  A traced session that lost its kernel events
is taken again there too, up to ``SESSION_TRIES`` times: one that kept no
device event, or kernel events for fewer than half the kernels the host
launched in it.  Every session on an H100 keeps a few kernel events fewer
than the host launched (42 of 50 launches of K2 alone with its wrapper's
ops, in each of 8 sessions; 26,403-26,409 of an Advanced step's 26,410), so
a session is not taken again for those.

A run on several ranks (``gymca_torch.bench``'s sharded windy runs,
``bench_scaling``) is timed by :func:`clock_on_ranks`: a barrier, a
synchronize, the run, a synchronize, and the slowest rank's seconds.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

__all__ = ["card", "kernel_durations_us", "cuda_ms", "host_us", "clock_on_ranks",
           "time_launches", "profile_steps", "time_steps", "device_note", "sync_errors"]

# Steps a traced run of a path makes (``time_steps``): a trace's events
# are read back in Python, and a step of the key chain alone launches
# hundreds of kernels, so longer traces take minutes to read.
TRACE_STEPS = 10
# A profiler session on the H100 keeps one event fewer than a batch
# launched as a rule and, now and then, none, at times in several sessions
# running: so up to this many sessions, a pause growing between them,
# before a timing gives up.
SESSION_TRIES = 10
# Host calls that launch one device kernel each, as the profiler names them,
# and the device events that are copies and fills rather than kernels.
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel")
NOT_KERNELS = ("Memcpy", "Memset")


def card() -> str:
    """The current card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def kernel_durations_us(fn: Callable[[], object], kernel: str) -> Dict[str, List[float]]:
    """Device durations (µs), by kernel name and in launch order, of every
    launch of a kernel whose name contains ``kernel`` during one call of
    ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA and kernel in e.name),
                    key=lambda e: e.time_range.start)
    out: Dict[str, List[float]] = {}
    for e in events:
        out.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return out


def cuda_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean time (ms) of ``fn()`` over ``reps`` calls between two CUDA
    events, host launch time included: for plain versions, whose many small
    kernels have no single name."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn: Callable[[], object], reps: int = 20) -> float:
    """Mean host time (µs) of ``fn()`` over ``reps`` calls, to a
    synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def clock_on_ranks(run: Callable[[], object], device, group=None):
    """One timed ``run()`` on every rank of the process ``group``, or on this
    process alone when ``group`` is None: a barrier over the group, a
    synchronize on a card, ``run()``, a synchronize.  Returns ``(run()'s
    result, this rank's seconds, the slowest rank's seconds)``, the last an
    all-reduce MAX over the group on ``parallel.mesh.collective_device()``
    (this rank's own without a group)."""
    sync = ((lambda: torch.cuda.synchronize(device)) if torch.device(device).type == "cuda"
            else (lambda: None))
    if group is not None:
        dist.barrier(group=group)
    sync()
    t0 = time.perf_counter()
    out = run()
    sync()
    own = time.perf_counter() - t0
    if group is None:
        return out, own, own
    from gymca_torch.parallel.mesh import collective_device

    took = torch.tensor([own], dtype=torch.float64, device=collective_device())
    dist.all_reduce(took, op=dist.ReduceOp.MAX, group=group)
    return out, own, float(took)


def time_launches(run: Callable[[], object], launches: int, kernel: str, reps: int = 3,
                  reset: Optional[Callable[[], object]] = None) -> dict:
    """Time ``run()``, which makes ``launches`` calls, each launching once
    every device kernel whose name contains ``kernel`` (K1's two passes, or
    one kernel).  ``reset()``, if given, restores the inputs before every
    call, outside the host clock.  A warm-up call in a profiler session
    names the kernels.  Returns device µs per call, the median over ``reps``
    repetitions of the sum of each kernel's mean event in a profiler session
    (a session is kept when each of those kernels kept at least half of its
    ``launches`` events and at most all of them, and no other kernel shows;
    another is made, up to ``SESSION_TRIES`` times, when not), the events
    each kept session saw, each kernel's median µs per call by name, and
    host µs per call, the best of ``reps`` repetitions of :func:`host_us`,
    with no profiler."""
    reset = reset or (lambda: None)
    for t in range(SESSION_TRIES):
        reset()
        names = sorted(kernel_durations_us(run, kernel))  # warm
        if names:
            break
        time.sleep(0.05 * (t + 1))
    else:
        raise RuntimeError(f"the profiler saw no kernel named like {kernel} in "
                           f"{SESSION_TRIES} warm-up calls")

    def whole(us):
        return sorted(us) == names and all(
            launches <= 2 * len(v) and len(v) <= launches for v in us.values())

    host, device, seen, means = [], [], [], []
    for _ in range(reps):
        reset()
        host.append(host_us(run, 1) / launches)
        for t in range(SESSION_TRIES):
            reset()
            us = kernel_durations_us(run, kernel)
            if whole(us):
                break
            time.sleep(0.05 * (t + 1))
        else:
            raise RuntimeError(f"the profiler saw {({k: len(v) for k, v in us.items()})} "
                               f"launches of {names}, expected {launches} of each, in each "
                               f"of {SESSION_TRIES} sessions")
        means.append({k: sum(v) / len(v) for k, v in us.items()})
        device.append(sum(means[-1].values()))
        seen.append(sum(len(v) for v in us.values()))
    return {"device_us": statistics.median(device), "host_us": min(host),
            "launches": launches, "seen": seen,
            "kernels": {k: statistics.median(m[k] for m in means) for k in names}}


def _traced(run: Callable[[], object]):
    """One profiler session of ``run()``: the profiler, the host seconds
    under it, the (start, end) of every device event, sorted, and how many
    of those are kernels against the kernel launches the host made."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    kernels = sum(1 for e in device if not e.name.startswith(NOT_KERNELS))
    launched = sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CPU and e.name.startswith(LAUNCH_CALLS))
    return prof, host_s, spans, kernels, launched


def profile_steps(run: Callable[[], object], steps: int, label: str, card: str,
                  top: int = 12, reset: Optional[Callable[[], object]] = None) -> Optional[dict]:
    """Trace ``run()``, which makes ``steps`` steps of a warmed-up path: device
    kernels per step, busy time, idle share and, printed, the ``top`` kernels
    by device time.  A session that kept no device event, or kernel events
    for fewer than half the kernels the host launched in it, is taken again
    (``reset()`` first, if given), up to ``SESSION_TRIES`` sessions, a pause
    growing between them; the line says how many it took and what the kept
    one saw.  Returns None, and says so, only when every session came back
    short."""
    from torch.autograd import DeviceType

    reset = reset or (lambda: None)
    for t in range(SESSION_TRIES):
        if t:
            time.sleep(0.05 * t)
            reset()
        prof, host_s, spans, kernels, launched = _traced(run)
        if spans and 2 * kernels >= launched:
            break
    else:
        print(f"[profile] [{card}] {label}: the profiler kept {kernels} kernel events of "
              f"{launched} launches in the last of {SESSION_TRIES} sessions; device kernels "
              f"per step not measured", flush=True)
        return None
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    idle = 1.0 - busy / span
    print(f"[profile] [{card}] {label}, {steps} steps traced: "
          f"{len(spans) / steps} device kernels/step, device busy {busy / steps} us/step "
          f"of a {span / steps} us/step device span (idle share {idle}); host wall "
          f"under the profiler {host_s * 1e6 / steps} us/step; {t + 1} session(s) taken, "
          f"the kept one with {kernels} kernel events of {launched} launches", flush=True)
    rows = sorted(
        (e for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.device_time_total > 0),
        key=lambda e: e.device_time_total, reverse=True,
    )
    for e in rows[:top]:
        print(f"[profile]   {e.device_time_total / steps:10.1f} us/step "
              f"{e.count / steps:8.1f} launches/step "
              f"{100 * e.device_time_total / busy:5.1f}%  {e.key[:90]}", flush=True)
    return {"kernels_per_step": len(spans) / steps, "idle_share": idle,
            "busy_us_per_step": busy / steps, "span_us_per_step": span / steps,
            "sessions": t + 1}


def time_steps(run: Callable[[int], object], steps: int, label: str, device,
               reset: Optional[Callable[[], object]] = None, reps: int = 3,
               card: Optional[str] = None, top: int = 5,
               trace_steps: int = TRACE_STEPS) -> dict:
    """One part of a step breakdown: ``run(k)`` makes the first ``k`` steps
    of the part, each call from the state ``reset()`` restores (outside the
    clock).  After one untimed call, host µs a step is the best of ``reps``
    calls of ``run(steps)``, each timed to a ``torch.cuda.synchronize()`` on
    a card.  On a card ``run(min(steps, trace_steps))`` is then traced
    (:func:`profile_steps`; a part of a few kernels a step, such as a kernel
    alone, can trace all its steps): ``busy_us_per_step``,
    ``kernels_per_step`` and ``idle_share`` (None where the profiler kept too
    few kernel events in every session, and on the CPU, where only the host
    clock runs)."""
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    reset = reset or (lambda: None)
    reset()
    run(steps)
    best = float("inf")
    for _ in range(reps):
        reset()
        sync()
        t0 = time.perf_counter()
        run(steps)
        sync()
        best = min(best, time.perf_counter() - t0)
    out = {"host_us": best / steps * 1e6, "busy_us_per_step": None,
           "kernels_per_step": None, "idle_share": None}
    if cuda:
        reset()
        traced = min(steps, trace_steps)
        prof = profile_steps(lambda: run(traced), traced, label,
                             card or torch.cuda.get_device_name(), top, reset)
        if prof is not None:
            out.update({k: prof[k] for k in ("busy_us_per_step", "kernels_per_step",
                                             "idle_share")})
    return out


def device_note(t: dict) -> str:
    """The device's numbers of a :func:`time_steps` result, for a line."""
    if t["busy_us_per_step"] is None:
        return "device not measured (host clock only)"
    return (f"device busy {t['busy_us_per_step']:.1f} us/step, "
            f"{t['kernels_per_step']:.1f} kernels/step, idle share {t['idle_share']:.3f}")


@contextlib.contextmanager
def sync_errors(device):
    """While open on a CUDA ``device``, ``torch.cuda.set_sync_debug_mode(
    "error")``: a call that makes the host wait for the card raises.  Nothing
    on the CPU."""
    if torch.device(device).type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)
