"""Device kernels a step: the profiler's kernel events (copies and fills
left out) over the profiled steps."""


def read(run):
    trace = run["trace"]
    return trace.kernels / len(run["traced"]) if trace is not None and trace.kernels else None
