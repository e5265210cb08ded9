"""RepeatCA — decouples agent time from CA time, over a batch of envs.

Counterpart of ``gymca_tpu/ops/repeat_ca.py``: accumulate
``t_acting(action) + t_perception(state)`` into ``accu_time``, split it into
whole and fractional parts, run the CA ``whole`` times and carry the
fraction.

* ``mode="modf"``   — a loop bounded by ``max_repeats`` in which each env
  takes the CA update only while its own repeat count lasts;
* ``mode="single"`` — exactly one CA step per env step.
"""

from __future__ import annotations

from typing import Callable

import torch

from gymca_torch import rng
from gymca_torch.config import TYPE_BOX
from gymca_torch.core.env import per_env, tree_map
from gymca_torch.core.operator import Operator

__all__ = ["RepeatCA", "modf"]


def modf(x: torch.Tensor):
    """``(frac, whole)`` as ``jnp.modf`` splits them: ``whole`` truncates
    toward zero, ``x - whole`` is exact in float32."""
    whole = torch.trunc(x)
    return x - whole, whole


class RepeatCA(Operator):
    grid_dependant = True
    action_dependant = True
    context_dependant = True

    def __init__(
        self,
        cellular_automaton: Operator,
        t_acting: Callable,
        t_perception: Callable,
        max_repeats: int = 2,
        mode: str = "modf",
        **kwargs,
    ):
        super().__init__(**kwargs)
        if mode not in ("modf", "single"):
            raise ValueError(f"mode must be 'modf' or 'single', got {mode!r}")
        self.ca = cellular_automaton
        self.t_acting = t_acting
        self.t_perception = t_perception
        self.max_repeats = int(max_repeats)
        self.mode = mode
        self.suboperators = (self.ca,)
        self.deterministic = self.ca.deterministic

    def update(self, grid, action, context, keys=None):
        ca_params, accu_time = context

        time_taken = self.t_acting(action) + self.t_perception((grid, context))
        frac, repeats = modf(accu_time + time_taken)

        if self.mode == "single":
            new_grid, new_params = self.ca(grid, action, ca_params, keys)
            return new_grid, (new_params, frac.to(TYPE_BOX))

        sub = rng.split(keys, self.max_repeats)
        for i in range(self.max_repeats):
            new_grid, new_params = self.ca(grid, action, ca_params, sub[..., i, :])
            pred = i < repeats
            grid = torch.where(per_env(pred, grid), new_grid, grid)
            ca_params = tree_map(
                lambda new, old: torch.where(per_env(pred, new), new, old),
                new_params, ca_params,
            )
        return grid, (ca_params, frac.to(TYPE_BOX))
