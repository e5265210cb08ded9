"""Drossel–Schwabl forest-fire CA over a batch of grids.

Counterpart of ``gymca_tpu/ops/drossel.py``.  Rule table:

* tree with >=1 fire Moore neighbour    -> fire
* tree otherwise                        -> fire w.p. ``p_fire`` (lightning)
* empty                                 -> tree w.p. ``p_tree`` (growth)
* fire                                  -> empty (burn out)

The fire-neighbour mask is a shifted OR over the 8 Moore views of one copy
padded with ``empty``; lightning and growth read two uniform fields drawn
from a split of each env's key, bit for bit as ``jax.random`` draws them.
The JAX package writes this as plain XLA (no Pallas kernel), so plain torch
ops stand in for it here.
"""

from __future__ import annotations

import torch

from gymca_torch import rng
from gymca_torch.core.operator import Operator
from gymca_torch.core.spaces import BoxSpec
from gymca_torch.ops.stencil import moore_shifts

__all__ = ["ForestFire", "drossel_step"]


def drossel_step(grid, p_fire, p_tree, keys, *, empty: int, tree: int, fire: int):
    """One Drossel–Schwabl update of ``(N, H, W)`` grids.

    ``p_fire`` and ``p_tree`` are floats or ``(N,)`` float32 tensors, ``keys``
    ``(N, 2)`` key data.  Returns a new grid of the same dtype."""
    pair = rng.split(keys)
    k_strike, k_grow = pair[..., 0, :], pair[..., 1, :]

    fire_neighbor = torch.zeros(grid.shape, dtype=torch.bool, device=grid.device)
    for _, view in moore_shifts(grid, empty):
        fire_neighbor = fire_neighbor | (view == fire)

    shape = grid.shape[-2:]
    u_strike = rng.uniform(k_strike, shape)
    u_grow = rng.uniform(k_grow, shape)

    def per_env(p):
        return p[..., None, None] if isinstance(p, torch.Tensor) else p

    is_tree = grid == tree
    is_empty = grid == empty
    is_fire = grid == fire

    new_grid = torch.where(
        is_tree & fire_neighbor,
        fire,
        torch.where(
            is_tree & (u_strike < per_env(p_fire)),
            fire,
            torch.where(
                is_empty & (u_grow < per_env(p_tree)),
                tree,
                torch.where(is_fire, empty, grid),
            ),
        ),
    )
    return new_grid.to(grid.dtype)


class ForestFire(Operator):
    """Operator over :func:`drossel_step`; the context is the ``(N, 2)``
    float32 ``(p_fire, p_tree)`` of each env."""

    grid_dependant = True
    action_dependant = False
    context_dependant = True
    deterministic = False

    def __init__(self, empty, tree, fire, **kwargs):
        super().__init__(**kwargs)
        self.empty, self.tree, self.fire = empty, tree, fire
        if self.context_spec is None:
            self.context_spec = BoxSpec(0.0, 1.0, shape=(2,))

    def update(self, grid, action, context, keys=None):
        new_grid = drossel_step(
            grid, context[..., 0], context[..., 1], keys,
            empty=self.empty, tree=self.tree, fire=self.fire,
        )
        return new_grid, context
