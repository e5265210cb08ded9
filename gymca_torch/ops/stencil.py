"""Shifted-neighbour views of a lattice, 2-D correlation and box sums.

Counterpart of ``gymca_tpu/ops/stencil.py``: Moore neighbourhoods are
whole-grid views of one padded copy (``NEIGHBOR_OFFSETS``, ``shift``,
``moore_shifts``); ``correlate2d`` is the dense oracle; ring kernels are
telescoped into Chebyshev box sums read from one summed-area table
(``multi_box_sums``, ``telescoped_box_coeffs``, ``ring_kernel_filter``).
Works on ``(..., H, W)`` tensors.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch
import torch.nn.functional as F

__all__ = ["NEIGHBOR_OFFSETS", "neighbor_offsets", "shift", "moore_shifts",
           "correlate2d", "multi_box_sums", "telescoped_box_coeffs",
           "ring_kernel_filter"]

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


def correlate2d(grid: torch.Tensor, kernel: torch.Tensor,
                dtype=torch.float32) -> torch.Tensor:
    """2-D cross-correlation with zero padding, "same" output shape:
    ``out[r, c] = sum_{i,j} grid[r + i - R, c + j - R] * kernel[i, j]``.
    The dense oracle of :func:`ring_kernel_filter`."""
    kh, kw = kernel.shape
    h, w = grid.shape[-2:]
    x = grid.reshape(-1, 1, h, w).to(dtype)
    k = kernel.to(device=x.device, dtype=dtype)[None, None]
    out = F.conv2d(x, k, padding=(kh // 2, kw // 2))
    return out.reshape(grid.shape[:-2] + (h, w))


def multi_box_sums(x: torch.Tensor, radii) -> dict:
    """Chebyshev box sums ``{r: sum over the (2r+1)^2 window}`` with a zero
    boundary, for several radii from one summed-area table.

    Exact for integer-valued inputs: the table is built in int64 and each
    box is cast back to ``x.dtype`` (the JAX package's float32 cumsum is
    exact for the counts it meets, below 2**24).
    """
    h, w = x.shape[-2:]
    sat = torch.cumsum(torch.cumsum(x.to(torch.int64), dim=-2), dim=-1)
    # Row/column 0 of the padded table is the empty prefix; past the last
    # row or column the table repeats its edge (no mass beyond the grid).
    sat = F.pad(sat, (1, 0, 1, 0))
    rows = torch.arange(h, device=x.device)
    cols = torch.arange(w, device=x.device)

    def at(r_idx, c_idx):
        return sat[..., r_idx[:, None], c_idx[None, :]]

    out = {}
    for r in radii:
        lo_r, hi_r = (rows - r).clamp(0, h), (rows + r + 1).clamp(0, h)
        lo_c, hi_c = (cols - r).clamp(0, w), (cols + r + 1).clamp(0, w)
        box = at(hi_r, hi_c) - at(lo_r, hi_c) - at(hi_r, lo_c) + at(lo_r, lo_c)
        out[r] = box.to(x.dtype)
    return out


def telescoped_box_coeffs(layer_weights) -> tuple:
    """Per-radius box-sum coefficients equivalent to a square-ring kernel:
    ``c_j = w_{j-1} - w_j`` for j < R, ``c_R = w_{R-1}`` (Python floats)."""
    n = len(layer_weights)
    coeffs = [layer_weights[j - 1] - layer_weights[j] for j in range(1, n)]
    coeffs.append(layer_weights[n - 1])
    return tuple(float(c) for c in coeffs)


def ring_kernel_filter(x: torch.Tensor, layer_weights) -> torch.Tensor:
    """Correlate float32 ``x`` with a square-ring kernel, weight
    ``layer_weights[i]`` on Chebyshev ring ``i+1`` (ring 1 also covering the
    centre), as ``sum_r c_r * box_r`` with the coefficients rounded to
    float32, accumulated in the order r = 1..R."""
    coeffs = telescoped_box_coeffs(layer_weights)
    radii = list(range(1, len(coeffs) + 1))
    boxes = multi_box_sums(x, radii)
    out = coeffs[0] * boxes[1]
    for r in radii[1:]:
        out = out + coeffs[r - 1] * boxes[r]
    return out
