"""Terrain generation for the Advanced Bulldozer env, over a batch of envs.

Counterpart of ``gymca_tpu/envs/terrain.py``:

* vegetation / density: random rectangular patches of type 1..5, leftover
  cells filled with 1..3;
* altitude: uniform noise + cosine hills + linear slopes, /10;
* per-cell 3x3 slope tensor ``degrees(atan(dalt))`` with diagonals /1.414,
  flat borders, zero centre;
* 8 directional 3x3 wind matrices ``exp(c1*V) * exp(V*c2*(cos(theta)-1))``,
  V=10, c1=0.045, c2=0.131;
* ``create_up_to_k_mappings`` for extension-combination action ids.

Every field is drawn from ``(N, 2)`` key data with the JAX package's key
chain, one env per key: the integer fields equal it bit for bit; altitude
and slope go through transcendentals that round differently from XLA's by a
few units in the last place.  The quirk of the reference is kept:
``get_winds(use_hidden)``'s non-hidden branch is dead, all 8 directional
matrices are returned regardless.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from gymca_torch import rng
from gymca_torch.config import TYPE_BOX, TYPE_INT, resolve_device

__all__ = [
    "init_vegetation",
    "init_density",
    "init_altitude",
    "init_vegetation_same",
    "init_density_same",
    "init_altitude_same",
    "get_slope",
    "get_winds",
    "calc_pw",
    "create_up_to_k_mappings",
    "WIND_THETAS",
]

MAX_PATCHES = 7  # the reference draws randint(4, 8) patches
MAX_HILLS = 9  # randint(6, 10) hills
MAX_SLOPES = 7  # randint(4, 8) slopes


def _scalar(keys, lo: int, hi: int) -> torch.Tensor:
    """One int32 draw in [lo, hi) per key, shaped (N, 1, 1) to broadcast
    over a lattice."""
    return rng.randint(keys, (), lo, hi)[:, None, None]


def _patch_field(keys: torch.Tensor, nrows: int, ncols: int) -> torch.Tensor:
    """Patch maps of ``len(keys)`` envs: sequential random rectangles of type
    1..5, zeros backfilled with 1..3."""
    sub = rng.split(keys, 2 + MAX_PATCHES)
    k_n, k_fill, k_patch = sub[:, 0], sub[:, 1], sub[:, 2]
    num_patches = rng.randint(k_n, (), 4, 8)[:, None, None]
    rows = torch.arange(nrows, dtype=TYPE_INT, device=keys.device)[:, None]
    cols = torch.arange(ncols, dtype=TYPE_INT, device=keys.device)[None, :]
    field = torch.zeros((keys.shape[0], nrows, ncols), dtype=TYPE_INT,
                        device=keys.device)
    for i in range(MAX_PATCHES):
        k = rng.split(rng.fold_in(k_patch, i), 5)
        center_row = _scalar(k[:, 0], 0, nrows)
        center_col = _scalar(k[:, 1], 0, ncols)
        patch_h = _scalar(k[:, 2], 3, max(nrows // 2, 4))
        patch_w = _scalar(k[:, 3], 3, max(ncols // 2, 4))
        ptype = _scalar(k[:, 4], 1, 6)
        inside = ((rows >= center_row - patch_h // 2)
                  & (rows < center_row + patch_h // 2)
                  & (cols >= center_col - patch_w // 2)
                  & (cols < center_col + patch_w // 2))
        field = torch.where((i < num_patches) & inside, ptype, field)
    filler = rng.randint(k_fill, (nrows, ncols), 1, 4)
    return torch.where(field == 0, filler, field).to(TYPE_INT)


def init_vegetation(key, nrows: int, ncols: int, num_envs: int) -> torch.Tensor:
    """(num_envs, H, W) int32 vegetation types from one (2,) key."""
    return _patch_field(rng.split(key, num_envs), nrows, ncols)


def init_density(key, nrows: int, ncols: int, num_envs: int) -> torch.Tensor:
    """(num_envs, H, W) int32 density types from one (2,) key."""
    return _patch_field(rng.split(key, num_envs), nrows, ncols)


def _altitude_field(keys: torch.Tensor, nrows: int, ncols: int) -> torch.Tensor:
    """Altitudes of ``len(keys)`` envs: noise + cosine hills + linear
    slopes, /10."""
    sub = rng.split(keys, 5)
    k_base, k_nh, k_hills, k_ns, k_slopes = (sub[:, i] for i in range(5))
    alt = rng.uniform(k_base, (nrows, ncols), minval=0.0, maxval=5.0)
    rows = torch.arange(nrows, device=keys.device).to(TYPE_BOX)[:, None]
    cols = torch.arange(ncols, device=keys.device).to(TYPE_BOX)[None, :]

    num_hills = rng.randint(k_nh, (), 6, 10)[:, None, None]
    max_radius = max(min(nrows, ncols) // 4, 3)
    for i in range(MAX_HILLS):
        k = rng.split(rng.fold_in(k_hills, i), 4)
        cr = _scalar(k[:, 0], 0, nrows).to(TYPE_BOX)
        cc = _scalar(k[:, 1], 0, ncols).to(TYPE_BOX)
        radius = _scalar(k[:, 2], 2, max_radius).to(TYPE_BOX)
        height = rng.uniform(k[:, 3], (), minval=2.0, maxval=6.0)[:, None, None]
        dist = torch.sqrt((rows - cr) ** 2 + (cols - cc) ** 2)
        factor = torch.cos(dist / radius * math.pi / 2)
        bump = torch.where(dist < radius, height * factor, 0.0)
        alt = alt + torch.where(i < num_hills, bump, 0.0)

    num_slopes = rng.randint(k_ns, (), 4, 8)[:, None, None]
    for i in range(MAX_SLOPES):
        k = rng.split(rng.fold_in(k_slopes, i), 5)
        start_row = _scalar(k[:, 0], 0, max(nrows - 4, 1))
        start_col = _scalar(k[:, 1], 0, max(ncols - 4, 1))
        width = _scalar(k[:, 2], 3, max(ncols // 4, 4))
        height = _scalar(k[:, 3], 3, max(nrows // 4, 4))
        height_diff = rng.uniform(k[:, 4], (), minval=1.0, maxval=4.0)[:, None, None]
        inside = ((rows >= start_row) & (rows < start_row + height)
                  & (cols >= start_col) & (cols < start_col + width))
        progress = (rows - start_row.to(TYPE_BOX)) / torch.clamp(
            height.to(TYPE_BOX), min=1.0)
        ramp = torch.where(inside, height_diff * progress, 0.0)
        alt = alt + torch.where(i < num_slopes, ramp, 0.0)
    return (alt / 10.0).to(TYPE_BOX)


def init_altitude(key, nrows: int, ncols: int, num_envs: int) -> torch.Tensor:
    """(num_envs, H, W) float32 altitudes from one (2,) key."""
    return _altitude_field(rng.split(key, num_envs), nrows, ncols)


# Uniform (non-hidden) variants.
def init_density_same(nrows, ncols, num_envs, device=None):
    return torch.full((num_envs, nrows, ncols), 3, dtype=TYPE_INT,
                      device=resolve_device(device))


def init_vegetation_same(nrows, ncols, num_envs, device=None):
    return torch.full((num_envs, nrows, ncols), 3, dtype=TYPE_INT,
                      device=resolve_device(device))


def init_altitude_same(nrows, ncols, num_envs, device=None):
    return torch.zeros((num_envs, nrows, ncols), dtype=TYPE_BOX,
                       device=resolve_device(device))


def get_slope(altitude: torch.Tensor) -> torch.Tensor:
    """Per-cell 3x3 slope tensor, (..., H, W) -> (..., H, W, 3, 3):
    ``slope[..., r, c, i, j] = degrees(atan((alt[r,c] - alt[r+i-1, c+j-1]) /
    (1.414 if diagonal)))``; border cells stay all-zero, the centre is 0."""
    h, w = altitude.shape[-2:]
    lead = altitude.shape[:-2]
    padded = torch.nn.functional.pad(
        altitude.reshape(-1, 1, h, w), (1, 1, 1, 1), mode="replicate"
    ).reshape(lead + (h + 2, w + 2))
    out = []
    for di in (-1, 0, 1):
        row_entries = []
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                row_entries.append(torch.zeros_like(altitude))
                continue
            neigh = padded[..., 1 + di:1 + di + h, 1 + dj:1 + dj + w]
            diff = altitude - neigh
            if di != 0 and dj != 0:
                diff = diff / 1.414
            row_entries.append(torch.rad2deg(torch.atan(diff)))
        out.append(torch.stack(row_entries, dim=-1))
    slope = torch.stack(out, dim=-2)  # (..., H, W, 3, 3)
    rows = torch.arange(h, device=altitude.device)
    cols = torch.arange(w, device=altitude.device)
    interior = (((rows > 0) & (rows < h - 1))[:, None]
                & ((cols > 0) & (cols < w - 1))[None, :])
    return torch.where(interior[..., None, None], slope, 0.0).to(TYPE_BOX)


# 8 directional theta tables; theta = angle between the wind direction and
# the fire-propagation direction.
WIND_THETAS = np.array(
    [
        [[45, 0, 45], [90, 0, 90], [135, 180, 135]],  # North
        [[90, 45, 0], [135, 0, 45], [180, 135, 90]],  # Northeast
        [[135, 90, 45], [180, 0, 0], [135, 90, 45]],  # East
        [[180, 135, 90], [135, 0, 45], [90, 45, 0]],  # Southeast
        [[135, 180, 135], [90, 0, 90], [45, 0, 45]],  # South
        [[90, 135, 180], [45, 0, 135], [0, 45, 90]],  # Southwest
        [[45, 90, 135], [0, 0, 180], [45, 90, 135]],  # West
        [[0, 45, 90], [45, 0, 135], [90, 135, 180]],  # Northwest
    ],
    dtype=np.float64,
)


def calc_pw(theta):
    """Alexandridis wind factor, in float64 numpy: ``(wind, ft)``."""
    c_1, c_2 = 0.045, 0.131
    V = 10
    t = np.radians(theta)
    ft = np.exp(V * c_2 * (np.cos(t) - 1))
    return np.exp(c_1 * V) * ft, ft


def get_winds(use_hidden: bool = True, device=None):
    """The 8 ``(wind_matrix, ft)`` tables as (8, 3, 3) float32 tensors on
    ``device``.  The reference's ``use_hidden=False`` branch is dead: all 8
    directional matrices are returned regardless."""
    wind_matrices, fts = [], []
    for thetas in WIND_THETAS:
        wind_matrix, ft = calc_pw(np.asarray(thetas))
        wind_matrix[1, 1] = 0.0
        wind_matrices.append(wind_matrix)
        fts.append(ft)
    device = resolve_device(device)
    return (torch.tensor(np.stack(wind_matrices).astype(np.float32), device=device),
            torch.tensor(np.stack(fts).astype(np.float32), device=device))


def create_up_to_k_mappings(n: int, k: int, device=None):
    """Mappings between combination ids and binary selection vectors:
    ``(id_to_binary (ids, n) int32 tensor, binary_to_id dict)``."""
    binary_vectors = []
    binary_to_id = {}
    for i in range(k + 1):
        for combo in itertools.combinations(range(n), i):
            binary = [0] * n
            for idx in combo:
                binary[idx] = 1
            binary = tuple(binary)
            binary_to_id[binary] = len(binary_vectors)
            binary_vectors.append(binary)
    return (torch.tensor(binary_vectors, dtype=TYPE_INT, device=resolve_device(device)),
            binary_to_id)
