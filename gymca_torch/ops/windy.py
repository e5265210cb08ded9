"""WindyForestFire — the 3-state windy CA rule over a batch of grids.

Counterpart of ``gymca_tpu/ops/windy.py``.  The rule table (Dead / Keep /
Propagate / Consume) is a weighted 3x3 score — centre weight 2^11, neighbour
weight 2^3 where that direction's gust succeeded — decoded by thresholds.
One 3x3 uniform roll per env per update gates every cell of that env.

Direction convention (scipy ``convolve2d`` kernel flip): the neighbour at
offset ``(dr, dc)`` is gated by ``wind[1 - dr, 1 - dc]``.
"""

from __future__ import annotations

from collections import namedtuple

import torch

from gymca_torch import rng
from gymca_torch.core.operator import Operator
from gymca_torch.core.spaces import BoxSpec
from gymca_torch.ops.stencil import moore_shifts

__all__ = [
    "IDENTITY",
    "PROPAGATION",
    "WindyForestFire",
    "windy_step",
    "windy_step_from_success",
    "windy_breaks",
    "assert_windy_encoding",
]

# Convolution weights of the rule encoding.
IDENTITY = 2**11
PROPAGATION = 2**3

Breaks = namedtuple("Breaks", ["keep", "propagate", "consume"])


def windy_breaks(empty: int, tree: int, fire: int) -> Breaks:
    """The 3 score breaks between the 4 rules."""
    keep_break = IDENTITY * tree
    propagate_break = IDENTITY * tree + PROPAGATION * fire
    consume_break = IDENTITY * fire
    return Breaks(keep_break, propagate_break, consume_break)


def assert_windy_encoding(empty: int, tree: int, fire: int) -> None:
    """Raise unless the score intervals separate the 4 rules."""
    n, i, p = 8, IDENTITY, PROPAGATION
    E, T, F = empty, tree, fire
    worst = n * p * F  # surrounded by fire
    checks = (
        (E < T < F, "Cell value ordering"),
        (p < i, "Weight ordering"),
        (i * E + worst < i * T, "Dead / Keep"),
        (i * T + n * p * T < i * T + p * F, "Keep / Propagate"),
        (i * T + worst < i * F, "Propagate / Consume"),
    )
    for ok, what in checks:
        if not ok:
            raise ValueError(f"windy encoding broken: {what}")


def windy_step_from_success(grid, success, *, empty: int, tree: int, fire: int):
    """Deterministic windy-CA update given the 3x3 gust-success masks.

    ``grid`` is ``(..., H, W)``; ``success`` is a bool ``(3, 3)`` mask shared
    by every grid, or ``(..., 3, 3)`` with one mask per grid.
    """
    g32 = grid.to(torch.int32)
    signal = IDENTITY * g32
    for (dr, dc), view in moore_shifts(g32, empty):
        w = torch.where(success[..., 1 - dr, 1 - dc], PROPAGATION, 0)
        signal = signal + w[..., None, None].to(torch.int32) * view

    b = windy_breaks(empty, tree, fire)
    return torch.where(
        signal >= b.consume,
        empty,  # Consume: FIRE -> EMPTY
        torch.where(
            signal >= b.propagate,
            fire,  # Propagate: TREE -> FIRE
            torch.where(signal >= b.keep, tree, empty),  # Keep / Dead
        ),
    ).to(grid.dtype)


def windy_step(grid, wind, keys, *, empty: int, tree: int, fire: int):
    """One windy-CA update of ``(N, H, W)`` grids, one gust roll per env.

    ``wind``: ``(3, 3)`` or ``(N, 3, 3)`` propagation probabilities;
    ``keys``: ``(N, 2)`` key data.  A direction fails where
    ``wind <= roll``.
    """
    roll = rng.uniform(keys, (3, 3))
    success = wind > roll
    return windy_step_from_success(
        grid, success, empty=empty, tree=tree, fire=fire
    )


class WindyForestFire(Operator):
    """Operator wrapper over :func:`windy_step`; the context is the wind."""

    grid_dependant = True
    action_dependant = False
    context_dependant = True
    deterministic = False

    def __init__(self, empty=0, tree=3, fire=25, **kwargs):
        super().__init__(**kwargs)
        self.empty, self.tree, self.fire = empty, tree, fire
        assert_windy_encoding(empty, tree, fire)
        self.breaks = windy_breaks(empty, tree, fire)
        if self.context_spec is None:
            self.context_spec = BoxSpec(0.0, 1.0, shape=(3, 3))

    def update(self, grid, action, wind, keys=None):
        new_grid = windy_step(
            grid, wind, keys, empty=self.empty, tree=self.tree, fire=self.fire
        )
        return new_grid, wind
