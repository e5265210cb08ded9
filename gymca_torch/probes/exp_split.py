"""Attribute K1's time to its work classes: ``scripts/exp_split.py`` on the
port.

    python3 -m gymca_torch.probes.exp_split [--envs 4096] [--size 256] [--steps 1000]
    python3 -m gymca_torch.probes.exp_split --envs 64 --size 32 --steps 10 --device-cpu

K1 (``windy_fused_step``) is driven directly by synthetic work lists at the
script's six class fractions, over the script's grid: ``choice(key(0), [0,
3, 25], (N, H, W), p=[0.099, 0.9, 0.001])`` int8.  Step ``t`` takes the
``t``-th key ``k`` of ``split(key(1), steps)`` and, as the script, ``u =
uniform(k, (N,))``: an env is a CA env where ``u < p_ca`` and shoots where
``p_ca <= u < p_ca + p_mod`` (CA envs shoot too), at ``randint(fold_in(k,
1), (N,), 0, H)`` and ``randint(fold_in(k, 2), (N,), 0, W)``, with weights
8 where ``uniform(fold_in(k, 3), (N, 8)) < 0.7`` and 0 elsewhere.  The grid
is carried from step to step, in place, and restored before every run.

The script draws each step's work list inside its jitted scan, where the
draws cost next to nothing; here every step's list is drawn in bulk
(bit for bit the same draws) before the clock starts, so the time is K1's
and its launch's.  Each line is the script's, with the device's own
numbers beside it (``probes.timing.time_steps``) and K1's device µs per
launch (``probes.kernel_inputs.time_k1``) beside its bound for those
inputs.  Runs on the card; ``--device-cpu`` runs K1's plain version on the
CPU with the host clock only.
"""

from __future__ import annotations

import argparse

import torch

from gymca_torch import rng
from gymca_torch.config import resolve_device
from gymca_torch.ops.windy_kernel import windy_fused_step
from gymca_torch.probes import kernel_inputs as ki
from gymca_torch.probes.timing import card, device_note, time_steps

__all__ = ["FRACTIONS", "CELLS", "CELL_P", "parse_args", "start_grid", "work_lists", "run",
           "main"]

# The script's cases: (label, p_ca, p_mod).
FRACTIONS = (
    ("noop only (prologue+launch)", 0.0, 0.0),
    ("bench-real  8% CA, 46% mod", 0.078, 0.46),
    ("CA only     8% CA,  0% mod", 0.078, 0.0),
    ("mod only    0% CA, 46% mod", 0.0, 0.46),
    ("all CA    100% CA", 1.0, 0.0),
    ("all mod     0% CA, 100% mod", 0.0, 1.0),
)
CELLS, CELL_P = (0, 3, 25), (0.099, 0.9, 0.001)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Attribute the windy kernel's time by class")
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--device-cpu", action="store_true",
                    help="run on the CPU (the plain version, host clock only)")
    return ap.parse_args(argv)


def start_grid(n: int, h: int, w: int, device):
    """The script's grid: ``choice(key(0), [0, 3, 25], (n, h, w), p)`` int8."""
    idx = rng.choice(rng.key(0, device=device), len(CELLS), (n, h, w), CELL_P)
    return torch.tensor(CELLS, dtype=torch.int8, device=device)[idx]


def work_lists(keys, n: int, h: int, w: int, p_ca: float, p_mod: float):
    """The script's work lists for the step keys ``keys`` (S, 2): weights
    (S, n, 8) and params (S, n, 4) int32, ``[do_ca, row, col, shoot |
    do_ca]``, drawn in bulk."""
    u = rng.uniform(keys, (n,))
    do_ca = u < p_ca
    shoot = (u >= p_ca) & (u < p_ca + p_mod)
    rows = rng.randint(rng.fold_in(keys, 1), (n,), 0, h)
    cols = rng.randint(rng.fold_in(keys, 2), (n,), 0, w)
    weights = torch.where(rng.uniform(rng.fold_in(keys, 3), (n, 8)) < 0.7, 8, 0)
    params = torch.stack([do_ca.to(torch.int32), rows, cols, (shoot | do_ca).to(torch.int32)],
                         dim=-1)
    return weights.to(torch.int32), params.contiguous()


def run(a) -> dict:
    """The six cases of parsed arguments ``a``: prints the script's lines
    with the device's numbers and returns each case's numbers by label."""
    dev = resolve_device("cpu" if a.device_cpu else None)
    on_card = dev.type == "cuda"
    smi = card() if on_card else None
    n, h, w, steps = a.envs, a.size, a.size, a.steps
    print(f"[exp_split] {n} envs x {h}x{w} int8, {steps} steps, "
          f"{smi or 'cpu (plain version)'}", flush=True)
    grid0 = start_grid(n, h, w, dev)
    grid = grid0.clone()
    keys = rng.split(rng.key(1, device=dev), steps)
    edits = torch.zeros((n, 0), dtype=torch.int32, device=dev)
    edit_counts = torch.zeros((n,), dtype=torch.int32, device=dev)
    out = {}
    for name, p_ca, p_mod in FRACTIONS:
        weights, params = work_lists(keys, n, h, w, p_ca, p_mod)

        def kernel(k):
            for wt, pm in zip(weights[:k], params[:k]):
                windy_fused_step(grid, wt, pm, edits, edit_counts, empty=0, tree=3, fire=25)

        t = time_steps(kernel, steps, f"{name.strip()}, {n} x {h}x{w}", dev,
                       reset=lambda: grid.copy_(grid0), card=smi, trace_steps=steps)
        if on_card:
            kin = [(wt, pm, edits, edit_counts) for wt, pm in zip(weights, params)]
            ms, bound_ms, by = ki.time_k1(smi, name.strip(), grid0, kin, 1)
            t.update(k1_device_us=ms * 1e3, k1_bound_us=bound_ms * 1e3, k1_bound_by=by)
            k1 = (f"K1 device {ms * 1e3:.2f} us/launch, bound {bound_ms * 1e3:.2f} us by {by} "
                  f"({bound_ms / ms:.0%} of it)")
        else:
            k1 = "K1 device time not measured (plain version on the CPU)"
        out[name.strip()] = t
        print(f"{name:30s}: {t['host_us']:7.1f} us/step  | {device_note(t)}; {k1}", flush=True)
    return out


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
