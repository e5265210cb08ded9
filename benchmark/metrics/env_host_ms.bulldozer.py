"""Host ms of a ``step_batched`` call, the mean over the traced run's
window: the benchmark's span around the call."""


def read(run):
    calls = run["spans"].get("step_batched")
    return 1e3 * sum(calls) / len(calls) if calls else None
