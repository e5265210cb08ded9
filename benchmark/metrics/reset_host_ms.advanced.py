"""Host ms of a ``conditional_reset`` call (it draws every env's fresh state
each step), the mean over the traced run's window."""


def read(run):
    calls = run["spans"].get("conditional_reset")
    return 1e3 * sum(calls) / len(calls) if calls else None
