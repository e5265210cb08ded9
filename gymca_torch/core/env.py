"""Functional CA environment core over a batch of envs.

Counterpart of ``gymca_tpu/core/env.py``:

* :class:`EnvState` / :class:`StepOutput` — the state and step result of N
  envs, every leaf with a leading batch dimension (the JAX package's state
  for one env, ``vmap``-ed);
* :class:`CAEnvCore` — ``initial_state(keys)`` and ``step(states, actions)``
  over that batch; ``step`` is the port's counterpart of
  ``jax.vmap(core.step)``, with the same key threading and the same
  termination freeze;
* :func:`autoreset_step` — step, then restart finished envs from fresh
  initial states;
* ``GymCAEnv`` — the classic single-env gymnasium adapter.  It lives in
  ``gymca_torch.gym_env``, which imports gymnasium, and is loaded from there
  only when asked for.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from gymca_torch import rng
from gymca_torch.config import TYPE_BOX, TYPE_INT

__all__ = ["EnvState", "StepOutput", "CAEnvCore", "GymCAEnv", "autoreset_step",
           "tree_map", "per_env"]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf by leaf over nested dicts, tuples, lists and
    dataclasses of tensors with the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *leaves) for leaves in zip(tree, *rest))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)
        })
    return fn(tree, *rest)


def per_env(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(N,) mask reshaped to broadcast against an (N, ...) leaf."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


@dataclasses.dataclass
class EnvState:
    """State of N environments; every leaf has a leading batch dimension."""

    grid: torch.Tensor  # (N, H, W) cell lattices
    context: Any  # env-specific dict of (N, ...) tensors
    key: torch.Tensor  # (N, 2) key data (gymca_torch.rng)
    done: torch.Tensor  # (N,) bool
    steps_elapsed: torch.Tensor  # (N,) int32
    reward_accumulated: torch.Tensor  # (N,) float32

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)

    def clone(self) -> "EnvState":
        return tree_map(torch.clone, self)


@dataclasses.dataclass
class StepOutput:
    obs: Any
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    info: dict


class CAEnvCore:
    """Functional CA environment over a batch of envs.

    Subclasses define ``mdp`` (an Operator), ``initial_state(keys)``,
    ``_award``, ``_is_done`` and ``observe``, and set ``device``.
    """

    nrows: int
    ncols: int
    device: torch.device

    @property
    def mdp(self):
        raise NotImplementedError

    def initial_state(self, keys) -> EnvState:
        raise NotImplementedError

    def _award(self, grid, context) -> torch.Tensor:
        raise NotImplementedError

    def _is_done(self, grid, context) -> torch.Tensor:
        raise NotImplementedError

    def _report(self, grid, context) -> dict:
        return {}

    def observe(self, state: EnvState):
        """Observation = (grid, context) by default."""
        return state.grid, state.context

    def step(self, state: EnvState, action) -> Tuple[EnvState, StepOutput]:
        """One MDP transition of every env in the batch.

        Termination-frozen semantics: once ``done``, further steps leave an
        env's state unchanged and give reward 0.0.
        """
        pair = rng.split(state.key)
        key, sub = pair[..., 0, :], pair[..., 1, :]
        new_grid, new_context = self.mdp(state.grid, action, state.context, sub)

        was_done = state.done
        new_grid = torch.where(per_env(was_done, new_grid), state.grid, new_grid)
        new_context = tree_map(
            lambda new, old: torch.where(per_env(was_done, new), old, new),
            new_context,
            state.context,
        )

        done = was_done | self._is_done(new_grid, new_context)
        reward = torch.where(
            was_done, torch.zeros((), dtype=TYPE_BOX, device=was_done.device),
            self._award(new_grid, new_context),
        )

        new_state = EnvState(
            grid=new_grid,
            context=new_context,
            key=key,
            done=done,
            steps_elapsed=state.steps_elapsed + (~was_done).to(TYPE_INT),
            reward_accumulated=state.reward_accumulated + reward,
        )
        out = StepOutput(
            obs=self.observe(new_state),
            reward=reward,
            terminated=done,
            truncated=torch.zeros_like(done),
            info=self._report(new_grid, new_context),
        )
        return new_state, out

    def reset(self, keys) -> Tuple[EnvState, Any]:
        state = self.initial_state(keys)
        return state, self.observe(state)

    def count_cells(self, grid, values) -> dict:
        """Per-value cell counts, one (N,) tensor per value."""
        return {v: (grid == v).sum(dim=(-2, -1)) for v in values}


def autoreset_step(core: CAEnvCore, state: EnvState, action):
    """Step, then restart terminated envs from a *fresh* initial state drawn
    with a new key (``gymca_tpu/core/env.py::autoreset_step``)."""
    new_state, out = core.step(state, action)
    pair = rng.split(new_state.key)
    reset_key, carry_key = pair[..., 0, :], pair[..., 1, :]
    fresh = core.initial_state(reset_key)
    merged = tree_map(
        lambda f, cur: torch.where(per_env(out.terminated, f), f, cur),
        fresh, new_state,
    )
    return merged.replace(key=carry_key), out


def __getattr__(name):
    if name == "GymCAEnv":  # imports gymnasium: loaded only on demand
        from gymca_torch.gym_env import GymCAEnv

        return GymCAEnv
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
