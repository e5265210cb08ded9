"""Grids cut into row bands over a mesh axis, stepped with halo exchange.

Counterpart of ``gymca_tpu/parallel/spatial.py``.  A grid too large for one
device is split into consecutive row bands, one per rank of a mesh axis;
each CA update first swaps ``radius`` rows with the ranks above and below
(:func:`exchange_row_halos`, point-to-point sends in one
``batch_isend_irecv``), then runs the ordinary stencil on the extended band
and keeps its own rows.  Nothing is sent past the grid's first and last
band: those halos are the edge fill, which equals the JAX package's
ring ``ppermute`` whose wrapped rows are then replaced by the fill.

Every function takes and returns this rank's band, not a global array:
:func:`shard_rows` cuts a band out of a grid every rank holds, and
:func:`gather_rows` puts the bands together again where a caller needs the
whole grid.  The windy step draws its gust once from the shared key, so
every rank applies the same global wind and the result equals the
single-device step bit for bit; the Alexandridis step draws each band's
per-cell uniforms from ``fold_in(key, band index)``, as the JAX package
does, so it equals the JAX function on the same mesh bit for bit.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from gymca_torch import rng
from gymca_torch.ops.windy import windy_step_from_success
from gymca_torch.parallel.mesh import axis_rank, axis_size

__all__ = ["exchange_row_halos", "shard_rows", "gather_rows", "windy_step_spatial",
           "alexandridis_bands", "alexandridis_step_spatial"]

# per-env entries handled apart from the (rows, ...) bands: exp_slope has its
# rows on axis -2, key does not enter the CA, true_grid is the grids argument
_APART = ("exp_slope", "key", "true_grid")


def _exchange_halos(items: Sequence[Tuple[torch.Tensor, object, int]], group,
                   radius: int = 1) -> List[torch.Tensor]:
    """:func:`exchange_row_halos` of several bands at once, every send and
    receive in one ``batch_isend_irecv``.  ``items`` holds ``(band, fill,
    dim)`` triples; ``dim`` is each band's row axis."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    above = dist.get_global_rank(group, idx - 1) if idx > 0 else None
    below = dist.get_global_rank(group, idx + 1) if idx < n - 1 else None
    ops, parts = [], []
    for i, (band, fill, dim) in enumerate(items):
        rows = band.shape[dim]
        if radius > rows:
            raise ValueError(f"a halo of {radius} rows exceeds the band {tuple(band.shape)}")
        last = band.narrow(dim, rows - radius, radius).contiguous()
        first = band.narrow(dim, 0, radius).contiguous()
        top = torch.full_like(last, fill)  # the band above's last rows
        bottom = torch.full_like(first, fill)  # the band below's first rows
        down, up = 2 * i, 2 * i + 1  # tags by direction
        if above is not None:
            ops += [dist.P2POp(dist.isend, first, above, group, up),
                    dist.P2POp(dist.irecv, top, above, group, down)]
        if below is not None:
            ops += [dist.P2POp(dist.isend, last, below, group, down),
                    dist.P2POp(dist.irecv, bottom, below, group, up)]
        parts.append((top, band, bottom, dim))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [torch.cat([top, band, bottom], dim) for top, band, bottom, dim in parts]


def exchange_row_halos(band: torch.Tensor, group, fill, radius: int = 1,
                       dim: int = 0) -> torch.Tensor:
    """This rank's band with ``radius`` rows of its neighbours' bands above
    and below along ``dim``: ``(rows + 2 * radius, ...)``.  The first band's
    top halo and the last band's bottom halo are ``fill``.  Requires
    ``radius <= rows`` (halos come from the next bands only)."""
    return _exchange_halos([(band, fill, dim)], group, radius)[0]


def shard_rows(x: torch.Tensor, mesh, axis: str = "data", dim: int = 0) -> torch.Tensor:
    """This rank's band of ``x``: its rows along ``dim`` cut into equal
    consecutive bands over ``mesh[axis]``.  Raises unless the rows divide."""
    n = axis_size(mesh, axis)
    rows = x.shape[dim]
    if rows % n:
        raise ValueError(f"grid rows {rows} not divisible by mesh axis size {n}")
    band = rows // n
    return x.narrow(dim, axis_rank(mesh, axis) * band, band)


def gather_rows(band: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The whole grid from every rank's band (an all-gather), for callers
    that read what the JAX package reads as a global array."""
    parts = [torch.empty_like(band) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, band.contiguous(), group=group)
    return torch.cat(parts, dim)


def windy_step_spatial(band: torch.Tensor, wind: torch.Tensor, key: torch.Tensor, mesh, *,
                       empty: int, tree: int, fire: int, axis: str = "data") -> torch.Tensor:
    """One windy-CA update of a grid cut into row bands over ``mesh[axis]``:
    this rank's ``(..., H/D, W)`` band in, its new band out.  Every rank
    draws the same gust ``rng.uniform(key, (3, 3))``, so the bands equal
    ``windy_step`` of the whole grid under the same key, bit for bit.
    ``wind`` and ``key`` may also carry a leading env axis, one gust per
    grid, as ``windy_step`` takes them."""
    success = wind > rng.uniform(key, (3, 3))  # the same global gust on every rank
    extended = exchange_row_halos(band, mesh.get_group(axis), empty, dim=-2)
    return windy_step_from_success(extended, success, empty=empty, tree=tree,
                                   fire=fire)[..., 1:-1, :]


def alexandridis_bands(ca, grids, per_envs: dict, shared: dict, keys, group):
    """The Alexandridis update of ``n`` envs whose grids are cut into row
    bands over ``group``: ``grids`` ``(n, rows, W)``, every per-env entry
    with a leading ``n`` and, where it is a band, its rows on axis 1
    (``exp_slope``'s on axis -2), ``keys`` ``(n, 2)``.  Returns this rank's
    ``(new grids, new fire ages)``.

    The halo is ``max(burn_kernel_radius, 2)`` rows: the heat kernel's
    reach, and at least the radius-2 dousing box even where the kernel's
    radius is 1.  The grid's halos outside the lattice are empty, the other
    bands' zero and ``exp_slope``'s 1.0.  Each band's draws come from
    ``fold_in(key, band index)``; the new wind index is dropped (the caller
    owns the global wind).
    """
    rows = grids.shape[1]
    r = max(ca.burn_kernel_radius, 2)
    if r > rows:
        raise ValueError(f"halo radius {r} exceeds band height {rows}")
    banded = [k for k, v in per_envs.items()
              if k not in _APART and isinstance(v, torch.Tensor) and v.dim() >= 3
              and v.shape[1] == rows]
    items = ([(grids, ca.empty, 1)] + [(per_envs[k], 0, 1) for k in banded]
             + [(per_envs["exp_slope"], 1.0, -2)])
    extended = _exchange_halos(items, group, r)
    context = {k: v for k, v in per_envs.items() if k not in banded and k not in _APART}
    context.update(zip(banded, extended[1:-1]))
    context["exp_slope"] = extended[-1]
    band_keys = rng.fold_in(keys, dist.get_rank(group))
    new_ext, (new_context, _) = ca.update(extended[0], None, (context, shared), band_keys)
    return new_ext[:, r:-r], new_context["fire_age"][:, r:-r]


def alexandridis_step_spatial(ca, band: torch.Tensor, per_env: dict, shared: dict,
                              key: torch.Tensor, mesh, *, axis: str = "data"):
    """One Alexandridis update of one env's grid cut into row bands over
    ``mesh[axis]``: ``band`` ``(H/D, W)`` and ``per_env`` one env's context
    with this rank's band of each ``(H, ...)`` entry (``exp_slope``
    ``(3, 3, H/D, W)``).  ``ca`` is an ``AlexandridisCA``, run on a batch of
    one.  Returns ``(new band, new fire age band)``; equal to the JAX
    function on a mesh of the same size bit for bit (see
    :func:`alexandridis_bands`)."""
    one = {k: v[None] if isinstance(v, torch.Tensor) else v for k, v in per_env.items()}
    grid, age = alexandridis_bands(ca, band[None], one, shared, key[None],
                                   mesh.get_group(axis))
    return grid[0], age[0]
