"""Env state carried between the JAX package and the port, as numpy arrays.

The env has no weights: what crosses between ``gymca_tpu`` and
``gymca_torch`` is the batched ``EnvState``.  The JAX side hands over its
leaves as numpy arrays (the key as ``jax.random.key_data(states.key)``,
uint32); :func:`env_state_from_numpy` builds the port's state from them on a
given device, and :func:`env_state_to_numpy` gives them back in the JAX
package's dtypes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gymca_torch.config import resolve_device
from gymca_torch.core.env import EnvState

__all__ = ["env_state_from_numpy", "env_state_to_numpy"]


def _to_torch(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x), device=device)  # a copy


def env_state_from_numpy(*, grid, context: Dict[str, np.ndarray], key, done,
                         steps_elapsed, reward_accumulated, device=None) -> EnvState:
    """The port's ``EnvState`` from the JAX state's leaves: ``grid`` (N, H, W),
    every ``context`` entry (``edit_log`` and ``edit_count`` included),
    ``key`` as (N, 2) uint32 key data, ``done``, ``steps_elapsed`` and
    ``reward_accumulated`` (N,)."""
    dev = resolve_device(device)
    key = np.asarray(key)
    if key.dtype != np.uint32 or key.shape[-1:] != (2,):
        raise ValueError(f"key must be (..., 2) uint32 key data, got "
                         f"{key.dtype} {key.shape}")
    return EnvState(
        grid=_to_torch(grid, dev),
        context={k: _to_torch(v, dev) for k, v in context.items()},
        key=_to_torch(key.astype(np.int64), dev),
        done=_to_torch(done, dev),
        steps_elapsed=_to_torch(steps_elapsed, dev),
        reward_accumulated=_to_torch(reward_accumulated, dev),
    )


def env_state_to_numpy(state: EnvState) -> Dict[str, object]:
    """The leaves of ``state`` as numpy arrays, keyed as
    :func:`env_state_from_numpy` takes them; the key as uint32 key data."""

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    return {
        "grid": host(state.grid),
        "context": {k: host(v) for k, v in state.context.items()},
        "key": host(state.key).astype(np.uint32),
        "done": host(state.done),
        "steps_elapsed": host(state.steps_elapsed),
        "reward_accumulated": host(state.reward_accumulated),
    }
