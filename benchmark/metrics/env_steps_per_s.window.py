"""Env-steps completed in the traced run's window over the window's seconds:
every env of the batch, every step, episode restarts inside; the window
ends on a synchronize.  The host's speed on a shared machine moves it by
more than an end-to-end bound can hold, so it is read per layer, beside
``step_ms_p95``."""


def read(run):
    return run["envs"] * run["steps"] / run["window_s"]
