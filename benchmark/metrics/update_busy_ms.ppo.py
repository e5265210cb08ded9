"""Device-busy ms of the kernels launched inside the program's span
``update`` (``PPOTrainer._update_ppo``: every minibatch's forward,
backward and optimizer step) in the profiled iteration: the union of their
intervals.  None where the program has no such span, or where over 1% of
the profiled kernels have no launch to place them by."""

from benchmark.spans import UNATTRIBUTED


def read(run):
    trace = run["trace"]
    if trace is None or not trace.kernels or "update" not in getattr(trace, "root_busy_s", {}):
        return None
    if trace.span_kernels.get(UNATTRIBUTED, 0) > 0.01 * trace.kernels:
        return None
    return 1e3 * trace.root_busy_s["update"]
