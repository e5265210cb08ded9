"""Env samples the trainer collected in the window (its counter: envs x
rollout steps an iteration) over the window's seconds."""


def read(run):
    counted = run.get("counters")
    return counted["samples_collected"] / run["window_s"] if counted else None
