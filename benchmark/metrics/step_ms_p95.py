"""The 95th percentile, over every step of the window, of the time between
consecutive steps' completion on the device (a CUDA event after each step,
no synchronisation per step); the step that restarts an episode counts."""

import numpy as np


def read(run):
    gaps = run["step_gaps_ms"]
    return float(np.percentile(gaps, 95)) if gaps else None
