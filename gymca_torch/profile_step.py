"""Breakdown of the batched windy-Bulldozer step: ``scripts/profile_step.py``
on the port.

    python3 -m gymca_torch.profile_step [--size 256] [--envs 4096] [--steps 1000]
    python3 -m gymca_torch.profile_step --size 32 --envs 64 --steps 20 --device-cpu

Times, per step, at ``--envs`` envs of ``--size``² (the script's 4096 x 256²,
1000 steps):

a) the full ``BulldozerCore.step_batched`` (kernel K1) from the reset of
   ``split(key(0), N)``, actions ``randint(k, (N, 2), 0, 2)`` with ``key, k =
   split(key)`` a step from ``key(0)``, as the script draws them;
b) K1 alone on the reset grid, with the script's weights
   (``windy_weights_from_roll`` of ``uniform(key(0), (N, 3, 3))``) and its
   ``(N, 6)`` params: every 7th env a CA env and the rest shooting at (100,
   100); every env a CA env; no CA env, 6 in 7 shooting; and a pure no-op.
   K1 reads columns 0-3 (``[do_ca, row, col, shoot]``) and so does the JAX
   kernel: the script's two extra zero columns change nothing there, so the
   port hands K1 the first four.  Row and column are 100 (the last row and
   column on grids of 100 or fewer);
c) the key chain alone: ``derive_step_key`` over the envs' keys, the carried
   keys stepped on;
d) the epilogue: weights from the rolls, the counts stacked, the reward.

Every part runs from the same start each time: K1 updates its grid in
place, so the start grid is copied back before every run, outside the
clock.  The actions of (a) are drawn in bulk before the clock starts (the
script draws them inside its jitted scan, where they cost next to nothing;
eagerly each draw is hundreds of small kernels).

Each line is the script's, with the device's own numbers beside it
(``probes.timing.time_steps``: host µs a step, the best of 3 runs to a
synchronize; device busy µs and kernels a step and the idle share from a
trace).  The K1 lines add K1's device µs per launch
(``probes.kernel_inputs.time_k1``) beside its bound for those inputs.  Runs
on the card; ``--device-cpu`` runs the plain versions on the CPU with the
host clock only.
"""

from __future__ import annotations

import argparse

import torch

from gymca_torch import rng
from gymca_torch.config import resolve_device
from gymca_torch.envs.bulldozer import BulldozerCore, derive_step_key
from gymca_torch.ops.windy_kernel import windy_fused_step, windy_weights_from_roll
from gymca_torch.probes import kernel_inputs as ki
from gymca_torch.probes.timing import TRACE_STEPS, card, device_note, time_steps

__all__ = ["parse_args", "action_draws", "synthetic_k1_inputs", "KERNEL_CASES", "run", "main"]

# The script's kernel-only cases: label -> how its (N, 6) params are set.
KERNEL_CASES = ("1/7 fire", "all fire", "none fire, all shoot", "pure no-op")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Breakdown of the batched Bulldozer step")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--device-cpu", action="store_true",
                    help="run on the CPU (plain versions, host clock only)")
    return ap.parse_args(argv)


def action_draws(key, steps: int, n: int):
    """The script's actions: ``key, k = split(key)`` a step, then
    ``randint(k, (n, 2), 0, 2)``; (steps, n, 2) int32."""
    ks = []
    for _ in range(steps):
        pair = rng.split(key)
        key = pair[0]
        ks.append(pair[1])
    return rng.randint(torch.stack(ks), (n, 2), 0, 2)


def synthetic_k1_inputs(core: BulldozerCore, key, n: int):
    """The script's kernel-only inputs: ``(rolls, weights, params)``, params
    the script's ``(n, 6)`` int32 table for each of :data:`KERNEL_CASES`."""
    rolls = rng.uniform(key, (n, 3, 3))
    weights = windy_weights_from_roll(core._wind, rolls)
    at = min(100, core.nrows - 1, core.ncols - 1)
    do_ca = (torch.arange(n, device=key.device) % 7 == 0).to(torch.int32)
    base = torch.zeros((n, 6), dtype=torch.int32, device=key.device)
    base[:, 0], base[:, 3] = do_ca, 1 - do_ca
    base[:, 1], base[:, 2] = at, at
    every, none = base.clone(), base.clone()
    every[:, 0] = 1
    none[:, 0] = 0
    noop = none.clone()
    noop[:, 3] = 0
    return rolls, weights, dict(zip(KERNEL_CASES, (base, every, none, noop)))


def run(a) -> dict:
    """The breakdown of parsed arguments ``a``: prints the script's lines
    with the device's numbers and returns each part's numbers by name."""
    dev = resolve_device("cpu" if a.device_cpu else None)
    on_card = dev.type == "cuda"
    smi = card() if on_card else None
    n, steps = a.envs, a.steps
    print(f"[profile_step] {n} envs x {a.size}x{a.size}, {steps} steps, "
          f"{smi or 'cpu (plain versions)'}", flush=True)
    core = BulldozerCore(a.size, a.size, device=dev)
    key = rng.key(0, device=dev)
    start = core.initial_state(rng.split(key, n))
    out = {}

    def part(name, fn, reset=None, trace_steps=TRACE_STEPS):
        out[name] = time_steps(fn, steps, f"{name}, {n} x {a.size}x{a.size}", dev,
                               reset=reset, card=smi, trace_steps=trace_steps)
        return out[name]

    # (a) the full step
    actions = action_draws(key, steps, n)
    held = {}

    def full(k):
        s = held["s"]
        for act in actions[:k]:
            s, _ = core.step_batched(s, act)

    t = part("full step_batched", full, reset=lambda: held.update(s=start.clone()))
    dt = t["host_us"] / 1e6
    print(f"full step_batched:  {dt * 1e6:9.1f} us/step  ({n / dt / 1e6:.2f} M env-steps/s)"
          f"  | {device_note(t)}", flush=True)

    # (b) K1 alone, the grid restored before every run
    rolls, weights, cases = synthetic_k1_inputs(core, key, n)
    grid0 = start.grid
    grid = grid0.clone()
    edits = torch.zeros((n, 0), dtype=torch.int32, device=dev)
    edit_counts = torch.zeros((n,), dtype=torch.int32, device=dev)
    for label, params6 in cases.items():
        params = params6[:, :4].contiguous()  # K1's [do_ca, row, col, shoot]

        def kernel(k):
            for _ in range(k):
                windy_fused_step(grid, weights, params, edits, edit_counts,
                                 empty=core._empty, tree=core._tree, fire=core._fire)

        name = f"kernel only ({label})"
        t = part(name, kernel, reset=lambda: grid.copy_(grid0), trace_steps=steps)
        if on_card:
            ms, bound_ms, by = ki.time_k1(smi, name, grid0,
                                          [(weights, params, edits, edit_counts)], steps)
            t.update(k1_device_us=ms * 1e3, k1_bound_us=bound_ms * 1e3, k1_bound_by=by)
            k1 = (f"K1 device {ms * 1e3:.2f} us/launch, bound {bound_ms * 1e3:.2f} us by {by} "
                  f"({bound_ms / ms:.0%} of it)")
        else:
            k1 = "K1 device time not measured (plain version on the CPU)"
        print(f"{name}: {t['host_us']:5.1f} us/step  | {device_note(t)}; {k1}", flush=True)

    # (c) the key chain alone
    def derive(k):
        keys = start.key
        for _ in range(k):
            keys, _ = derive_step_key(keys)

    t = part("derive only", derive)
    print(f"derive only:        {t['host_us']:9.1f} us/step  | {device_note(t)}", flush=True)

    # (d) weights from (b)'s rolls, counts stacked, reward
    zeros = torch.zeros((n,), dtype=torch.int32, device=dev)

    def epilogue(k):
        for _ in range(k):
            w = windy_weights_from_roll(core._wind, rolls)
            counts = torch.stack([start.context["tree_count"], start.context["fire_count"],
                                  zeros, zeros], dim=-1)
            tr = counts[..., 0].to(torch.float32)
            f = counts[..., 1].to(torch.float32)
            reward = -(f / torch.clamp(tr + f, min=1.0))
            reward.sum() + w.sum()

    t = part("epilogue-ish", epilogue)
    print(f"epilogue-ish:       {t['host_us']:9.1f} us/step  | {device_note(t)}", flush=True)
    return out


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
