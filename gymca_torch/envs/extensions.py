"""Extension system: purchasable observation channels and obs transforms,
over a batch of envs.

Counterpart of ``gymca_tpu/envs/extensions.py``:

* ``apply_blur`` — 3x3 mean blur of the /3-normalised grid with edge
  padding, rounded back to integers: the transform that obscures daytime
  observations;
* ``apply_visibility`` — hides cell value 3 during daytime.  The reference's
  quirk is kept: the Advanced env's fire value is 2, so this is a no-op
  there;
* the registry: ``unblur`` (skip_blur) and ``see_invisible_fires``
  (skip_visibility), at most one active, chosen through a combinatorial
  action id;
* ``apply_extensions`` — per-extension transformed grids gated by the
  binary action bits.

Grids are ``(N, H, W)``; per-env flags (``is_night``, action bits) are
``(N,)`` and broadcast over each env's lattice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "apply_blur",
    "apply_visibility",
    "transform_grid",
    "apply_extensions",
    "ExtensionInfo",
    "ExtensionRegistry",
    "EXTENSION_REGISTRY",
    "total_extensions",
    "extension_choices",
]

VISIBILITY_HIDDEN_VALUE = 3  # the reference hides 3; the Advanced fire is 2


def _per_env(flag, like: torch.Tensor):
    """A per-env flag shaped to broadcast over ``like``'s (N, H, W)
    lattices: an (N,) tensor gains trailing axes; a number or a 0-d tensor
    broadcasts as it is."""
    if isinstance(flag, torch.Tensor) and flag.ndim:
        return flag.reshape(flag.shape + (1,) * (like.ndim - flag.ndim))
    return flag


def _select(flag, if_set, otherwise, like):
    """``if_set`` where the per-env ``flag`` is nonzero, else ``otherwise``;
    a flag that is a Python number picks one on the host."""
    if isinstance(flag, torch.Tensor):
        return torch.where(_per_env(flag, like) != 0, if_set, otherwise)
    return if_set if flag else otherwise


def apply_visibility(grid, is_night):
    """Hide value-3 cells during daytime."""
    hidden = (grid == VISIBILITY_HIDDEN_VALUE) & (_per_env(is_night, grid) == 0)
    return torch.where(hidden, 0, grid)


def apply_blur(grid):
    """Uniform 3x3 blur with edge padding: /3-normalise, average with weight
    float32(1/9) summed over the window in row-major order, round back
    (half to even) to int32."""
    normalized = grid.to(torch.float32) / 3.0
    h, w = grid.shape[-2:]
    lead = grid.shape[:-2]
    padded = F.pad(normalized.reshape(-1, 1, h, w), (1, 1, 1, 1),
                   mode="replicate").reshape(lead + (h + 2, w + 2))
    weight = 1.0 / 9.0
    blurred = torch.zeros_like(normalized)
    for i in range(3):
        for j in range(3):
            blurred = blurred + weight * padded[..., i:i + h, j:j + w]
    return torch.round(blurred * 3.0).to(torch.int32)


def transform_grid(grid, is_night, skip_visibility, skip_blur):
    """Conditionally blur, then hide."""
    grid = _select(skip_blur, grid, apply_blur(grid), grid)
    return _select(skip_visibility, grid, apply_visibility(grid, is_night), grid)


@dataclass(frozen=True)
class ExtensionInfo:
    """One purchasable observation channel."""

    index: int
    name: str
    skip_visibility: int = 0
    skip_blur: int = 0


@dataclass(frozen=True)
class ExtensionRegistry:
    extensions: Tuple[ExtensionInfo, ...]
    choose: int  # most simultaneously active


# Default registry: unblur + see-invisible-fires, choose 1.
EXTENSION_REGISTRY: Tuple[ExtensionRegistry, ...] = (
    ExtensionRegistry(
        extensions=(
            ExtensionInfo(0, "unblur", skip_visibility=0, skip_blur=1),
            ExtensionInfo(1, "see_invisible_fires", skip_visibility=1, skip_blur=0),
        ),
        choose=1,
    ),
)


def extension_choices(registry=EXTENSION_REGISTRY):
    """``[(n, k)]`` per registry group."""
    return [(len(reg.extensions), reg.choose) for reg in registry]


def total_extensions(registry=EXTENSION_REGISTRY) -> int:
    return sum(len(reg.extensions) for reg in registry)


def apply_extensions(grid, ext_action_bits, is_night, enable_extensions: bool,
                     registry=EXTENSION_REGISTRY):
    """Per-extension channels, zero unless that extension's bit is set.

    ``ext_action_bits``: (N, total_extensions) binary selection from the
    combinatorial action id.  Returns a list of (N, H, W) channels, one per
    extension, in registry order.
    """
    if not enable_extensions:
        return [torch.zeros_like(grid) for reg in registry for _ in reg.extensions]
    channels = []
    i = 0
    for reg in registry:
        for ext in sorted(reg.extensions, key=lambda e: e.index):
            transformed = transform_grid(grid, is_night,
                                         skip_visibility=ext.skip_visibility,
                                         skip_blur=ext.skip_blur)
            channels.append(_select(ext_action_bits[..., i] > 0, transformed,
                                    torch.zeros_like(grid), grid).to(grid.dtype))
            i += 1
    return channels
