"""Agent operators: Move, Modify, MoveModify, over a batch of envs.

Counterpart of ``gymca_tpu/ops/move_modify.py``:

* ``Move``   — action in 0..8 (Moore directions, row-major with 4 =
  not_move) displaces the agent, clamped at the borders;
* ``Modify`` — when the modify sub-action is truthy, substitutes the grid
  cell at the agent position through an ``effects`` mapping and reports a
  ``hit`` flag in the context;
* ``ModifyDousing`` — the Advanced env's shot: writes
  ``dousing_count[pos] = 1``; the grid itself is untouched.
"""

from __future__ import annotations

from typing import Dict, Set

import torch

from gymca_torch.config import TYPE_INT, resolve_device
from gymca_torch.core.operator import Operator
from gymca_torch.core.spaces import DiscreteSpec, MultiDiscreteSpec

__all__ = ["Move", "Modify", "ModifyDousing", "MoveModify", "DEFAULT_DIRECTIONS",
           "move_position"]

# Action ids 0..8:
#   0 up_left, 1 up, 2 up_right, 3 left, 4 not_move, 5 right,
#   6 down_left, 7 down, 8 down_right
DEFAULT_DIRECTIONS: Dict[str, Set[int]] = {
    "up": {0, 1, 2},
    "down": {6, 7, 8},
    "left": {0, 3, 6},
    "right": {2, 5, 8},
    "not_move": {4},
}


def _set_to_delta(directions: Dict[str, Set[int]], device=None,
                  n_actions: int = 9):
    """Per-action (drow, dcol) lookup tables, int32 tensors on ``device``
    (the card unless the caller names another)."""
    device = resolve_device(device)
    drow = [0] * n_actions
    dcol = [0] * n_actions
    for a in range(n_actions):
        if a in directions["up"]:
            drow[a] -= 1
        if a in directions["down"]:
            drow[a] += 1
        if a in directions["left"]:
            dcol[a] -= 1
        if a in directions["right"]:
            dcol[a] += 1
    return (torch.tensor(drow, dtype=TYPE_INT, device=device),
            torch.tensor(dcol, dtype=TYPE_INT, device=device))


def move_position(position, action, nrows: int, ncols: int, drow, dcol):
    """Clamped displacement: ``(..., 2)`` positions, ``(...)`` actions.

    A move into the wall keeps that coordinate, which equals clipping the
    target to the grid box.
    """
    a = action.long()
    row = torch.clamp(position[..., 0] + drow[a], 0, nrows - 1)
    col = torch.clamp(position[..., 1] + dcol[a], 0, ncols - 1)
    return torch.stack([row, col], dim=-1).to(TYPE_INT)


class Move(Operator):
    grid_dependant = False
    action_dependant = True
    context_dependant = True
    deterministic = True

    def __init__(self, directions_sets: Dict[str, Set[int]] = None, device=None,
                 **kwargs):
        super().__init__(**kwargs)
        directions_sets = directions_sets or DEFAULT_DIRECTIONS
        self.directions_sets = directions_sets
        self.drow, self.dcol = _set_to_delta(directions_sets, device)
        if self.action_spec is None:
            self.action_spec = DiscreteSpec(9)

    def update(self, grid, action, position, keys=None):
        nrows, ncols = grid.shape[-2], grid.shape[-1]
        return grid, move_position(position, action, nrows, ncols, self.drow,
                                   self.dcol)


class Modify(Operator):
    grid_dependant = True
    action_dependant = True
    context_dependant = True
    deterministic = True

    def __init__(self, effects: Dict[int, int], device=None, **kwargs):
        super().__init__(**kwargs)
        self.effects = dict(effects)
        device = resolve_device(device)
        keys = list(effects.keys()) or [0]
        vals = [effects.get(k, 0) for k in keys]
        self.effect_keys = torch.tensor(keys, dtype=TYPE_INT, device=device)
        self.effect_values = torch.tensor(vals, dtype=TYPE_INT, device=device)
        self.has_effects = len(effects) > 0
        if self.action_spec is None:
            self.action_spec = DiscreteSpec(2)

    def update(self, grid, action, position, keys=None):
        """``(N, H, W)`` grids, ``(N,)`` actions, ``(N, 2)`` positions ->
        ``(grid, (position, hit))``."""
        n = grid.shape[0]
        if not self.has_effects:
            return grid, (position, torch.zeros((n,), dtype=torch.bool,
                                                device=grid.device))
        env = torch.arange(n, device=grid.device)
        row, col = position[..., 0].long(), position[..., 1].long()
        cell = grid[env, row, col]
        do = action.to(torch.bool)
        match = cell[:, None].to(TYPE_INT) == self.effect_keys
        found = match.any(dim=-1)
        mapped = torch.where(
            found, self.effect_values[match.to(torch.int8).argmax(dim=-1)],
            cell.to(TYPE_INT),
        ).to(grid.dtype)
        hit = do & found
        new_grid = grid.clone()
        new_grid[env, row, col] = torch.where(do, mapped, cell)
        return new_grid, (position, hit)


class ModifyDousing(Operator):
    """Advanced-env shooting: mark ``dousing_count[pos] = 1`` where the
    action is 1.  Context = ``(position, dousing_count)``: (N, 2) positions
    and (N, H, W) counts; returns a new count tensor."""

    grid_dependant = False
    action_dependant = True
    context_dependant = True
    deterministic = True

    def update(self, grid, action, context, keys=None):
        position, dousing_count = context
        env = torch.arange(dousing_count.shape[0], device=dousing_count.device)
        row, col = position[..., 0].long(), position[..., 1].long()
        new_dousing = dousing_count.clone()
        new_dousing[env, row, col] = torch.where(
            action == 1, 1, dousing_count[env, row, col]).to(dousing_count.dtype)
        return grid, (position, new_dousing)


class MoveModify(Operator):
    """Composite move-then-modify:
    ``update(grid, actions, position) -> (grid, (position, hit))`` with
    ``actions[..., 0]`` the move and ``actions[..., 1]`` the modify action."""

    grid_dependant = True
    action_dependant = True
    context_dependant = True
    deterministic = True

    def __init__(self, move: Move, modify: Modify, **kwargs):
        super().__init__(**kwargs)
        self.move = move
        self.modify = modify
        self.suboperators = (move, modify)
        if self.action_spec is None and move.action_spec is not None:
            self.action_spec = MultiDiscreteSpec((9, 2))

    def update(self, grid, subactions, position, keys=None):
        move_action, modify_action = subactions[..., 0], subactions[..., 1]
        grid, position = self.move(grid, move_action, position)
        grid, (position, hit) = self.modify(grid, modify_action, position)
        return grid, (position, hit)
