"""Host ms of a ``stateless_step`` call, the mean over the traced run's
window: the benchmark's span around the call."""


def read(run):
    calls = run["spans"].get("stateless_step")
    return 1e3 * sum(calls) / len(calls) if calls else None
