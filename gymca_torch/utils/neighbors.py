"""Moore neighbourhoods of one cell, on tensors.

Counterpart of ``gymca_tpu/utils/neighbors.py`` (``moore_n``,
``neighborhood_at``, ``Neighbors``): pad, then index.  ``pos`` may be a
pair of ints or a tensor on the grid's device; nothing here waits for the
device.  These helpers serve user code, renders and tests; the CA steps
use whole-grid shifted views (``gymca_torch.ops.stencil``).
"""

from __future__ import annotations

from collections import namedtuple

import torch
import torch.nn.functional as F

__all__ = ["moore_n", "neighborhood_at", "Neighbors"]

Neighbors = namedtuple(
    "Neighbors",
    [
        "up_left", "up", "up_right",
        "left", "self_", "right",
        "down_left", "down", "down_right",
    ],
)


def moore_n(n: int, pos, grid: torch.Tensor, invariant=0) -> torch.Tensor:
    """The radius-``n`` Moore neighbourhood of ``pos`` in an ``(..., H, W)``
    grid, out-of-bounds cells filled with ``invariant``: ``(..., 2n+1,
    2n+1)``.  A position outside the grid is read as ``lax.dynamic_slice``
    reads its start in the padded grid: a negative one counts from the end,
    then the window is clamped inside."""
    h, w = grid.shape[-2:]
    padded = F.pad(grid, (n, n, n, n), mode="constant", value=invariant)
    offsets = torch.arange(2 * n + 1, device=grid.device)

    def start(p, size):
        p = torch.as_tensor(p, device=grid.device)
        return torch.clamp(torch.where(p < 0, p + size + 2 * n, p), 0, size - 1)

    rows, cols = start(pos[0], h) + offsets, start(pos[1], w) + offsets
    return padded[..., rows[:, None], cols[None, :]]


def neighborhood_at(grid: torch.Tensor, pos, invariant=0) -> Neighbors:
    """The 9 cells around ``pos`` as a namedtuple of tensors."""
    w = moore_n(1, pos, grid, invariant)
    return Neighbors(
        up_left=w[..., 0, 0], up=w[..., 0, 1], up_right=w[..., 0, 2],
        left=w[..., 1, 0], self_=w[..., 1, 1], right=w[..., 1, 2],
        down_left=w[..., 2, 0], down=w[..., 2, 1], down_right=w[..., 2, 2],
    )
