"""Shifted-neighbour views of a lattice.

Counterpart of the Moore-neighbourhood part of ``gymca_tpu/ops/stencil.py``
(``NEIGHBOR_OFFSETS``, ``shift``, ``moore_shifts``): neighbourhoods are
whole-grid views of one padded copy.  Works on ``(..., H, W)`` tensors.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch
import torch.nn.functional as F

__all__ = ["NEIGHBOR_OFFSETS", "neighbor_offsets", "shift", "moore_shifts"]

# The 8 Moore offsets, row-major order (a 3x3 kernel scan skipping the centre).
NEIGHBOR_OFFSETS: Tuple[Tuple[int, int], ...] = tuple(
    (dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1) if not (dr == 0 and dc == 0)
)


def neighbor_offsets() -> Tuple[Tuple[int, int], ...]:
    return NEIGHBOR_OFFSETS


def _pad(grid: torch.Tensor, fill) -> torch.Tensor:
    return F.pad(grid, (1, 1, 1, 1), mode="constant", value=fill)


def shift(grid: torch.Tensor, dr: int, dc: int, fill) -> torch.Tensor:
    """Return S with ``S[..., r, c] = grid[..., r + dr, c + dc]``
    (out-of-bounds -> fill), for ``|dr|, |dc| <= 1``."""
    h, w = grid.shape[-2], grid.shape[-1]
    return _pad(grid, fill)[..., 1 + dr:1 + dr + h, 1 + dc:1 + dc + w]


def moore_shifts(
    grid: torch.Tensor, fill
) -> Iterator[Tuple[Tuple[int, int], torch.Tensor]]:
    """Yield ``((dr, dc), shifted_grid)`` for the 8 Moore neighbours, all
    views of a single padded copy of the grid."""
    h, w = grid.shape[-2], grid.shape[-1]
    padded = _pad(grid, fill)
    for dr, dc in NEIGHBOR_OFFSETS:
        yield (dr, dc), padded[..., 1 + dr:1 + dr + h, 1 + dc:1 + dc + w]
