"""The gymnasium adapter: the classic single-env API over the batched cores.

Counterpart of ``GridSpace`` (``gymca_tpu/core/gym_compat.py``), ``GymCAEnv``
(``gymca_tpu/core/env.py``), ``ForestFireBulldozerEnv``
(``gymca_tpu/envs/bulldozer.py``), ``ForestFireHelicopterEnv``
(``gymca_tpu/envs/helicopter.py``) and the spec -> space conversion
(``Spec.to_gymnasium``).  With ``gymca_torch.registration`` it is the only
module of the port that imports gymnasium: ``gymca_torch``,
``gymca_torch.core.env`` and the env modules load it on demand, so the rest
of the port runs where gymnasium is not installed.
"""

from __future__ import annotations

from typing import Optional, Sequence

import gymnasium as gym
import gymnasium.spaces as gs
import numpy as np
import torch
from gymnasium import logger

from gymca_torch import rng
from gymca_torch.core.env import CAEnvCore, tree_map
from gymca_torch.core.spaces import (
    BoxSpec,
    DictSpec,
    DiscreteSpec,
    GridSpec,
    MultiDiscreteSpec,
    TupleSpec,
)
from gymca_torch.envs.bulldozer import BulldozerCore
from gymca_torch.envs.helicopter import HelicopterCore

__all__ = ["GridSpace", "space_of", "GymCAEnv", "ForestFireBulldozerEnv",
           "ForestFireHelicopterEnv"]


def _numpy_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


class GridSpace(gs.Space):
    """``gym.Space`` over integer lattices, a view of a :class:`GridSpec`
    (``gymca_tpu/core/gym_compat.py``).

    Construct from a cell count or an explicit cell-value list::

        GridSpace(n=3, shape=(2, 2))
        GridSpace(values=[0, 3, 25], shape=(2, 2), probs=[0.1, 0.9, 0.0])

    or from a spec with :meth:`from_spec`.
    """

    def __init__(
        self,
        n: Optional[int] = None,
        values: Optional[Sequence[int]] = None,
        shape: tuple = (),
        probs: Optional[Sequence[float]] = None,
        dtype=np.int32,
        seed: Optional[int] = None,
    ):
        np_dtype = _numpy_dtype(dtype)
        self._spec = GridSpec(
            shape=tuple(shape),
            n=n,
            values=None if values is None else tuple(int(v) for v in values),
            probs=None if probs is None else tuple(probs),
            dtype=torch.from_numpy(np.empty(0, np_dtype)).dtype,
        )
        self._named_by_values = values is not None
        super().__init__(self._spec.shape, np_dtype, seed)

    @classmethod
    def from_spec(cls, spec: GridSpec, seed: Optional[int] = None) -> "GridSpace":
        """The space of a spec, as ``GridSpec.to_gymnasium`` builds it."""
        return cls(values=list(spec.values), shape=spec.shape, probs=list(spec.probs),
                   dtype=spec.dtype, seed=seed)

    @property
    def spec(self) -> GridSpec:
        """The underlying spec (its batched ``sample(keys)`` draws on a device)."""
        return self._spec

    @property
    def values(self) -> np.ndarray:
        return np.asarray(self._spec.values, dtype=self.dtype)

    @property
    def n(self) -> int:
        return self._spec.n

    @property
    def probs(self) -> np.ndarray:
        return np.asarray(self._spec.probs)

    @property
    def size(self) -> int:
        return self._spec.size

    def contains(self, x) -> bool:
        # No dtype cast: it would accept 0.5 as 0, or 259 as 3 at int8.
        # Input that is no array is outside, never an exception.
        try:
            return self._spec.contains(np.asarray(x))
        except (TypeError, ValueError):
            return False

    def sample(self, mask=None, probability=None) -> np.ndarray:
        flat = self.np_random.choice(self.values, size=self.size, p=self.probs)
        return flat.reshape(self.shape)

    def __eq__(self, other):
        if not isinstance(other, GridSpace):
            return False
        return self.shape == other.shape and np.array_equal(self.values, other.values)

    def __repr__(self):
        inner = (f"values={list(self._spec.values)}" if self._named_by_values
                 else f"n={self.n}")
        return f"GridSpace({inner}, shape={self.shape})"

    @property
    def is_np_flattenable(self):
        return True


@gs.flatten.register(GridSpace)
def _flatten_grid_space(space, x):
    return np.asarray(x, dtype=space.dtype).flatten()


@gs.flatdim.register(GridSpace)
def _flatdim_grid_space(space):
    return int(space.size)


@gs.unflatten.register(GridSpace)
def _unflatten_grid_space(space, x):
    return np.asarray(x, dtype=space.dtype).reshape(space.shape)


def space_of(spec):
    """The gymnasium space of a spec."""
    if isinstance(spec, GridSpec):
        return GridSpace.from_spec(spec)
    if isinstance(spec, BoxSpec):
        return gs.Box(spec.low, spec.high, shape=spec.shape, dtype=np.float32)
    if isinstance(spec, DiscreteSpec):
        return gs.Discrete(spec.n)
    if isinstance(spec, MultiDiscreteSpec):
        return gs.MultiDiscrete(np.asarray(spec.nvec), dtype=np.int64)
    if isinstance(spec, TupleSpec):
        return gs.Tuple(tuple(space_of(s) for s in spec.specs))
    if isinstance(spec, DictSpec):
        return gs.Dict({k: space_of(s) for k, s in spec.specs})
    raise TypeError(f"no gymnasium space for {type(spec).__name__}")


def _host(tree):
    """Env 0 of a batched tree of tensors, as numpy."""
    return tree_map(lambda t: t[0].detach().cpu().numpy(), tree)


class GymCAEnv(gym.Env):
    """Classic single-env gymnasium adapter over a :class:`CAEnvCore`: a batch
    of one env, stepped by the core's eager step.  ``step`` after done warns
    once and returns reward 0.0; ``reset`` draws a fresh initial state."""

    metadata = {"render_modes": ["human"], "render_mode": "rgb_array"}

    def __init__(self, core: CAEnvCore, seed: Optional[int] = None):
        self.core = core
        self.nrows, self.ncols = core.nrows, core.ncols
        self._key = rng.key(0 if seed is None else seed, device=core.device)
        self._state = None
        self.steps_beyond_done = 0
        self.done = False
        self.steps_elapsed = 0
        self.reward_accumulated = 0.0

        self.action_space = core.action_spec.to_gymnasium()
        self.observation_space = core.observation_spec.to_gymnasium()

    @property
    def grid(self):
        return self._state.grid[0].cpu().numpy()

    @property
    def context(self):
        return _host(self._state.context)

    @property
    def state(self):
        return self.grid, self.context

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        super().reset(seed=seed)
        if seed is not None:
            self._key = rng.key(seed, device=self.core.device)
        pair = rng.split(self._key)
        self._key, sub = pair[0], pair[1]
        self._state = self.core.initial_state(sub[None])
        self.done = False
        self.steps_elapsed = 0
        self.reward_accumulated = 0.0
        self.steps_beyond_done = 0
        return _host(self.core.observe(self._state)), {}

    def step(self, action):
        if not self.done:
            action = torch.as_tensor(np.asarray(action), device=self.core.device)
            self._state, out = self.core.step(self._state, action[None])
            reward = float(out.reward[0])
            self.done = bool(out.terminated[0])
            self.steps_elapsed += 1
            self.reward_accumulated += reward
            return _host(out.obs), reward, self.done, False, _host(out.info)
        if self.steps_beyond_done == 0:
            logger.warn(
                "You are calling 'step()' even though this environment has "
                "already returned done = True. You should always call "
                "'reset()' once you receive 'done = True' -- any further "
                "steps are undefined behavior."
            )
        self.steps_beyond_done += 1
        return _host(self.core.observe(self._state)), 0.0, True, False, {}

    def status(self):
        return {
            "steps_elapsed": self.steps_elapsed,
            "reward_accumulated": self.reward_accumulated,
        }

    def count_cells(self, grid=None):
        """Dict of cell counts."""
        from collections import Counter

        grid = self.grid if grid is None else np.asarray(grid)
        return Counter(grid.flatten().tolist())

    def render(self):
        return None


class ForestFireBulldozerEnv(GymCAEnv):
    """Classic gymnasium-API windy Bulldozer."""

    def __init__(self, nrows, ncols, seed: Optional[int] = None, **kwargs):
        kwargs.pop("debug", None)
        core = BulldozerCore(nrows, ncols, **kwargs)
        super().__init__(core, seed=seed)
        self.title = core.title
        self._empty, self._tree, self._fire = core._empty, core._tree, core._fire

    def render(self):
        from gymca_torch.utils.render import render_bulldozer

        return render_bulldozer(self)


class ForestFireHelicopterEnv(GymCAEnv):
    """Classic gymnasium-API Helicopter."""

    def __init__(self, nrows, ncols, seed: Optional[int] = None, **kwargs):
        kwargs.pop("debug", None)
        core = HelicopterCore(nrows, ncols, **kwargs)
        super().__init__(core, seed=seed)
        self.title = core.title
        self._empty, self._tree, self._fire = core._empty, core._tree, core._fire

    def render(self):
        from gymca_torch.utils.render import render_helicopter

        return render_helicopter(self)
