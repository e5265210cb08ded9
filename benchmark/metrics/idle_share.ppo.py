"""The share of the profiled iteration's host window in which no operation
ran on the device: 100 (1 - busy / window), busy the union of the device
events' intervals."""


def read(run):
    trace = run["trace"]
    if trace is None or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
