"""Space specs, sampled from ``gymca_torch.rng`` keys.

Counterpart of ``gymca_tpu/core/spaces.py``.  Every spec is a frozen config
object with

* ``sample(keys)`` — draws from ``(..., 2)`` key data, batched over the
  leading key dimensions, bit for bit as the JAX spec draws from one key;
* ``contains(x)`` — host-side containment check;
* ``to_gymnasium()`` — conversion for the gymnasium adapter, which imports
  gymnasium only when called (``gymca_torch.gym_env``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from gymca_torch import rng
from gymca_torch.config import TYPE_BOX, TYPE_INT

__all__ = [
    "Spec",
    "GridSpec",
    "BoxSpec",
    "DiscreteSpec",
    "MultiDiscreteSpec",
    "TupleSpec",
    "DictSpec",
]


class Spec:
    """Base class for all specs."""

    def sample(self, keys):  # pragma: no cover - abstract
        raise NotImplementedError

    def contains(self, x) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError

    def to_gymnasium(self):
        from gymca_torch.gym_env import space_of

        return space_of(self)


def _freeze(x) -> tuple:
    return tuple(x) if not isinstance(x, tuple) else x


@functools.lru_cache(maxsize=64)
def _device_values(values: Tuple[int, ...], dtype, device: torch.device) -> torch.Tensor:
    """``values`` as a tensor on ``device``, copied there once."""
    return torch.tensor(values, dtype=dtype, device=device)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass(frozen=True)
class GridSpec(Spec):
    """Space of integer cellular-automaton lattices, from ``n`` or explicit
    ``values`` with optional per-value ``probs``."""

    shape: Tuple[int, ...]
    n: Optional[int] = None
    values: Optional[Tuple[int, ...]] = None
    probs: Optional[Tuple[float, ...]] = None
    dtype: Any = TYPE_INT

    def __post_init__(self):
        if not self.shape:
            raise ValueError("GridSpec needs an explicit lattice shape")
        object.__setattr__(self, "shape", _freeze(self.shape))
        if self.values is not None:
            vals = tuple(int(v) for v in np.unique(np.asarray(self.values)))
            object.__setattr__(self, "values", vals)
            object.__setattr__(self, "n", len(vals))
        elif self.n is not None:
            if self.n <= 0:
                raise ValueError("cell count 'n' must be >= 1")
            object.__setattr__(self, "values", tuple(range(self.n)))
        else:
            raise ValueError("GridSpec needs either 'n' or 'values'")
        if self.probs is None:
            object.__setattr__(self, "probs", tuple([1.0 / self.n] * self.n))
        else:
            object.__setattr__(self, "probs", tuple(float(p) for p in self.probs))
        if len(self.values) != len(self.probs):
            raise ValueError(
                "need exactly one sampling probability per distinct cell value"
            )

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def sample(self, keys: torch.Tensor) -> torch.Tensor:
        """``(..., 2)`` keys -> ``(..., *shape)`` lattices of ``dtype``."""
        values = _device_values(self.values, self.dtype, keys.device)
        idx = rng.choice(keys, self.n, self.shape, self.probs)
        return values[idx]

    def contains(self, x) -> bool:
        x = _numpy(x)
        return (
            set(np.unique(x).tolist()).issubset(set(self.values))
            and tuple(x.shape) == self.shape
        )

    def __repr__(self):
        return f"GridSpec(values={list(self.values)}, shape={self.shape})"


@dataclass(frozen=True)
class BoxSpec(Spec):
    low: float
    high: float
    shape: Tuple[int, ...] = ()
    dtype: Any = TYPE_BOX

    def __post_init__(self):
        object.__setattr__(self, "shape", _freeze(self.shape))

    def sample(self, keys: torch.Tensor) -> torch.Tensor:
        if not np.isfinite(self.high):
            # unbounded above: low + Exp(1), as the JAX spec draws it
            x = self.low + rng.exponential(keys, self.shape)
        else:
            x = rng.uniform(keys, self.shape, minval=self.low, maxval=self.high)
        return x.to(self.dtype)

    def contains(self, x) -> bool:
        x = _numpy(x)
        return (
            tuple(x.shape) == self.shape
            and bool(np.all(x >= self.low))
            and bool(np.all(x <= self.high))
        )


@dataclass(frozen=True)
class DiscreteSpec(Spec):
    n: int

    def sample(self, keys: torch.Tensor) -> torch.Tensor:
        return rng.randint(keys, (), 0, self.n)

    def contains(self, x) -> bool:
        x = _numpy(x)
        if x.shape != () or not np.issubdtype(x.dtype, np.number):
            return False  # non-scalar / non-numeric input is simply outside
        return bool(x == int(x)) and 0 <= int(x) < self.n


@dataclass(frozen=True)
class MultiDiscreteSpec(Spec):
    nvec: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "nvec", _freeze(self.nvec))

    @property
    def shape(self):
        return (len(self.nvec),)

    def sample(self, keys: torch.Tensor) -> torch.Tensor:
        sub = rng.split(keys, len(self.nvec))
        return torch.stack(
            [rng.randint(sub[..., i, :], (), 0, n) for i, n in enumerate(self.nvec)],
            dim=-1,
        )

    def contains(self, x) -> bool:
        x = _numpy(x)
        return x.shape == (len(self.nvec),) and bool(
            np.all((x >= 0) & (x < np.asarray(self.nvec)))
        )


@dataclass(frozen=True)
class TupleSpec(Spec):
    specs: Tuple[Spec, ...]

    def __post_init__(self):
        object.__setattr__(self, "specs", _freeze(self.specs))

    def sample(self, keys: torch.Tensor):
        sub = rng.split(keys, len(self.specs))
        return tuple(s.sample(sub[..., i, :]) for i, s in enumerate(self.specs))

    def contains(self, x) -> bool:
        return len(x) == len(self.specs) and all(
            s.contains(v) for s, v in zip(self.specs, x)
        )


@dataclass(frozen=True)
class DictSpec(Spec):
    specs: Tuple[Tuple[str, Spec], ...]

    @classmethod
    def of(cls, **specs: Spec) -> "DictSpec":
        return cls(tuple(sorted(specs.items())))

    def __post_init__(self):
        if isinstance(self.specs, dict):
            object.__setattr__(self, "specs", tuple(sorted(self.specs.items())))

    def keys(self):
        return [k for k, _ in self.specs]

    def __getitem__(self, key: str) -> Spec:
        for k, s in self.specs:
            if k == key:
                return s
        raise KeyError(key)

    def sample(self, keys: torch.Tensor):
        sub = rng.split(keys, max(len(self.specs), 1))
        return {k: s.sample(sub[..., i, :]) for i, (k, s) in enumerate(self.specs)}

    def contains(self, x) -> bool:
        return set(x.keys()) == set(self.keys()) and all(
            s.contains(x[k]) for k, s in self.specs
        )
