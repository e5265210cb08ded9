"""ForestFireHelicopter — the Drossel–Schwabl fire-fighting task over a batch
of envs.

Counterpart of ``gymca_tpu/envs/helicopter.py``:

* cells ``0/1/2 = empty/tree/fire``, ``p_fire=0.033``, ``p_tree=0.333``;
* the helicopter always shoots, with effects ``{fire: empty}``;
* a freeze counter gates the CA: it applies only when ``freeze == 0``, that
  is every ``max_freeze + 1`` steps, ``max_freeze = int(speed * ((nrows +
  ncols) // 2))``;
* reward = weighted relative cell counts ``(0, +1, -1)``; never terminates.

``HelicopterCore.step`` (inherited from :class:`CAEnvCore`) is the batched
counterpart of ``jax.vmap(core.step)``; the reward rounds as the jitted JAX
step rounds it.  ``ForestFireHelicopterEnv``, the gymnasium env, lives in
``gymca_torch.gym_env`` and is loaded from there only when asked for.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gymca_torch import rng
from gymca_torch.config import TYPE_BOX, TYPE_INT, resolve_device
from gymca_torch.core.env import CAEnvCore, EnvState, per_env
from gymca_torch.core.operator import Operator
from gymca_torch.core.spaces import (
    BoxSpec,
    DiscreteSpec,
    GridSpec,
    MultiDiscreteSpec,
    TupleSpec,
)
from gymca_torch.ops.drossel import ForestFire
from gymca_torch.ops.move_modify import DEFAULT_DIRECTIONS, Modify, Move, MoveModify

__all__ = ["HelicopterMDP", "HelicopterCore", "ForestFireHelicopterEnv"]


class HelicopterMDP(Operator):
    """Freeze-gated CA, then an always-shooting MoveModify; the context is a
    dict {ca_params, position, freeze, hit} of (N, ...) tensors."""

    grid_dependant = True
    action_dependant = True
    context_dependant = True
    deterministic = False

    def __init__(self, ca: ForestFire, move_modify: MoveModify, max_freeze: int,
                 **kwargs):
        super().__init__(**kwargs)
        self.ca = ca
        self.move_modify = move_modify
        self.max_freeze = max_freeze
        self.suboperators = (ca, move_modify)

    def update(self, grid, action, context, keys=None):
        ca_params, position, freeze = (
            context["ca_params"], context["position"], context["freeze"])
        k_ca = rng.split(keys)[..., 0, :]

        ca_grid, ca_params = self.ca(grid, None, ca_params, k_ca)
        do_ca = freeze == 0
        grid = torch.where(per_env(do_ca, grid), ca_grid, grid)

        action = action.to(TYPE_INT)
        shoot = torch.ones_like(action)  # the helicopter always shoots
        grid, (position, hit) = self.move_modify(
            grid, torch.stack([action, shoot], dim=-1), position)

        freeze = torch.where(do_ca, self.max_freeze, freeze - 1).to(TYPE_INT)
        return grid, {
            "ca_params": ca_params,
            "position": position,
            "freeze": freeze,
            "hit": hit,
        }


class HelicopterCore(CAEnvCore):
    """Functional Helicopter core over a batch of envs.

    Runs on ``device``: the card unless the caller names another; without a
    CUDA device, ``device=None`` raises.
    """

    def __init__(
        self,
        nrows: int,
        ncols: int,
        speed: float = 0.5,
        freeze: Optional[int] = None,
        p_fire: float = 0.033,
        p_tree: float = 0.333,
        device=None,
    ):
        self.device = resolve_device(device)
        self.nrows, self.ncols = nrows, ncols
        self.title = f"ForestFireHelicopter{nrows}x{ncols}"

        self._empty, self._tree, self._fire = 0, 1, 2
        self._p_fire, self._p_tree = p_fire, p_tree
        self._reward_per_empty = 0.0
        self._reward_per_tree = 1.0
        self._reward_per_fire = -1.0
        self._effects = {self._fire: self._empty}

        scale = (nrows + ncols) // 2
        self._max_freeze = int(speed * scale) if freeze is None else freeze

        # initial context rows, copied to the device once: a copy per reset
        # would make the host wait for the device
        self._ca_params0 = torch.tensor([p_fire, p_tree], dtype=TYPE_BOX, device=self.device)
        self._position0 = torch.tensor([nrows // 2, ncols // 2], dtype=TYPE_INT,
                                       device=self.device)

        self._set_specs()

        self.ca = ForestFire(self._empty, self._tree, self._fire)
        self.move = Move(DEFAULT_DIRECTIONS, device=self.device)
        self.modify = Modify(self._effects, device=self.device)
        self.move_modify = MoveModify(self.move, self.modify)
        self._mdp = HelicopterMDP(self.ca, self.move_modify, self._max_freeze)

    def _set_specs(self):
        nrows, ncols = self.nrows, self.ncols
        self.grid_spec = GridSpec(
            values=(self._empty, self._tree, self._fire), shape=(nrows, ncols))
        self.ca_params_spec = BoxSpec(0.0, 1.0, shape=(2,))
        self.position_spec = MultiDiscreteSpec((nrows, ncols))
        self.freeze_spec = DiscreteSpec(self._max_freeze + 1)
        self.context_spec = TupleSpec(
            (self.ca_params_spec, self.position_spec, self.freeze_spec))
        self.action_spec = DiscreteSpec(9)
        self.observation_spec = TupleSpec((self.grid_spec, self.context_spec))

    @property
    def mdp(self):
        return self._mdp

    def initial_state(self, keys: torch.Tensor) -> EnvState:
        """Initial states of ``len(keys)`` envs from ``(N, 2)`` key data."""
        keys = keys.to(self.device)
        n = keys.shape[0]
        pair = rng.split(keys)
        k_grid, k_carry = pair[:, 0], pair[:, 1]
        grid = self.grid_spec.sample(k_grid)

        def full(value, dtype, *shape):
            return torch.full((n, *shape), value, dtype=dtype, device=self.device)

        context = {
            "ca_params": self._ca_params0.expand(n, 2).clone(),
            "position": self._position0.expand(n, 2).clone(),
            "freeze": full(self._max_freeze, TYPE_INT),
            "hit": full(False, torch.bool),
        }
        return EnvState(
            grid=grid,
            context=context,
            key=k_carry,
            done=full(False, torch.bool),
            steps_elapsed=full(0, TYPE_INT),
            reward_accumulated=full(0.0, TYPE_BOX),
        )

    def observe(self, state: EnvState):
        c = state.context
        return state.grid, (c["ca_params"], c["position"], c["freeze"])

    def _award(self, grid, context):
        """``dot(weights, counts / ncells)`` in float32, as the jitted JAX step
        computes it: XLA turns the division by the constant cell count into a
        multiply by its float32 reciprocal, then sums the products in order
        (the eager JAX step divides, and differs in the last bit on about one
        reward in five)."""
        inv = float(np.float32(1.0) / np.float32(self.nrows * self.ncols))
        reward = None
        for value, weight in ((self._empty, self._reward_per_empty),
                              (self._tree, self._reward_per_tree),
                              (self._fire, self._reward_per_fire)):
            frac = (grid == value).sum(dim=(-2, -1)).to(TYPE_BOX) * inv
            term = frac * weight
            reward = term if reward is None else reward + term
        return reward

    def _is_done(self, grid, context):
        return torch.zeros(grid.shape[0], dtype=torch.bool, device=grid.device)

    def _report(self, grid, context):
        return {"hit": context["hit"]}


def __getattr__(name):
    if name == "ForestFireHelicopterEnv":  # imports gymnasium: loaded on demand
        from gymca_torch.gym_env import ForestFireHelicopterEnv

        return ForestFireHelicopterEnv
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
