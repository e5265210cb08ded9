"""Timing of the port's kernels on the card.

A kernel's time is read from the profiler's CUDA kernel events: the
kernel's own time on the card.  CUDA events around a Python loop of wrapper
calls read the host instead, because each wrapper's checks make the card
wait for the next launch (K1's idle floor read 24-44 µs that way and 4.81 µs
from the kernel events on an H100).  :func:`time_launches` is the one
policy for a kernel's time: host time per launch is the host clock to a
``torch.cuda.synchronize()``, the best of a few repetitions; device time
per launch is the median of the repetitions' means, each repetition in a
profiler session of its own.  On an H100 the profiler now and then loses
some or all of a session's kernel events, and one session in a few dozen
has read half the kernel's time that every other session read: a session
that kept fewer than half of the launches, or more events than there were
launches, is made again (up to three times), and the median hides one
session that reads short.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, List, Optional

import torch

__all__ = ["card", "kernel_durations_us", "cuda_ms", "host_us", "time_launches"]

SESSION_TRIES = 3


def card() -> str:
    """The current card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def kernel_durations_us(fn: Callable[[], object], kernel: str) -> List[float]:
    """Device durations (µs), in launch order, of every launch of a kernel
    whose name contains ``kernel`` during one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA and kernel in e.name),
                    key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() for e in events]


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


def time_launches(run: Callable[[], object], launches: int, kernel: str, reps: int = 3,
                  reset: Optional[Callable[[], object]] = None) -> dict:
    """Time ``run()``, which launches the kernel named ``kernel``
    ``launches`` times.  ``reset()``, if given, restores the inputs before
    every call, outside the host clock.  After one warm-up call, returns
    device µs per launch, the median over ``reps`` repetitions of the mean
    of the kernel events a profiler session kept (at least half of the
    launches and at most all of them; another session is made, up to
    ``SESSION_TRIES`` times, when one is not), the events each kept
    session saw, and host µs per launch, the best of ``reps`` repetitions
    of :func:`host_us`, with no profiler."""
    reset = reset or (lambda: None)
    reset()
    run()  # warm
    host, device, seen = [], [], []
    for _ in range(reps):
        reset()
        host.append(host_us(run, 1) / launches)
        for _ in range(SESSION_TRIES):
            reset()
            us = kernel_durations_us(run, kernel)
            if launches <= 2 * len(us) and len(us) <= launches:
                break
        else:
            raise RuntimeError(f"the profiler saw {len(us)} launches of {kernel}, "
                               f"expected {launches}, in each of {SESSION_TRIES} sessions")
        device.append(sum(us) / len(us))
        seen.append(len(us))
    return {"device_us": statistics.median(device), "host_us": min(host),
            "launches": launches, "seen": seen}
