"""The whole step's share of the card's peak over the window, in %: the
operations of the samples the trainer passed forward only (the policy's and
GAE's bootstrap, each through the torso, the actor and the critic) and
forward and backward (the minibatches), by the program's counters and
:mod:`benchmark.flops` from the configuration's shapes, over the window's
seconds at 494.7 TFLOP/s, the H100 SXM data sheet's dense TF32 rate at 700 W
(the result line gives the card's limit).  The convolutions run in TF32;
the dense layers' float32 share of the operations is under 1%."""

from benchmark import flops

PEAK_FLOPS = 494.7e12


def read(run):
    counted = run.get("counters")
    if not counted:
        return None
    cfg = run["config"]
    ops = (counted["samples_forward"] * flops.forward(cfg)
           + counted["samples_trained"] * flops.forward_backward(cfg))
    return 100.0 * ops / (run["window_s"] * PEAK_FLOPS)
