"""The legacy SEQUENTIAL Alexandridis prototype: a behavioural spec, run on
the host.

Counterpart of ``gymca_tpu/ops/alexandridis_legacy.py``, the per-cell,
order-dependent NumPy update that the vectorised ``AlexandridisCA``
superseded.  It defines the sequential semantics the batched CA
deliberately departs from:

* cells update in row-major order against the OLD grid for neighbourhoods
  but the NEW grid for writes;
* a pinecone landing ignites its cell at once and marks it skipped, so
  later cells of the SAME pass leave it alone (an order dependence a
  vectorised update can only approximate);
* its vegetation/density tables differ from the batched CA's, and the slope
  is one scalar per cell, not a 3x3 stencil;
* fire ages are drawn in [4, 10], not the grid-scaled range.

It is NumPy with a stateful ``np.random.Generator`` (one env, on the host),
as the JAX package's is: from the same Generator seed and the same inputs
the two give the same grid and context cell for cell.  Tensors are taken
too and read back to the host first.  ``AlexandridisCA`` is the device path.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SequentialAlexandridisCA"]

# Legacy lookup tables.
_VEG_BURN = {1: -0.3, 2: 0.0, 3: 0.3, 4: 0.6, 5: 1.0}
_DEN_BURN = {1: -0.4, 2: 0.0, 3: 0.3, 4: 0.6, 5: 1.0}
_VEG_PINE = {1: 0.0, 2: 0.8, 3: 1.6, 4: 2.0, 5: 2.5}
_DEN_PINE = {1: 0.0, 2: 0.6, 3: 1.2, 4: 1.5, 5: 2.0}
_P_H = 0.58
_SLOPE_COEFF = 0.078

# Pinecone direction lookups.
_LOOKUP_GRID = [(0, 0), (0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1), (2, 2)]
_DX = [1, 1, 0, -1, -1, -1, 0, 1]
_DY = [0, 1, 1, 1, 0, -1, -1, -1]


def _host(x):
    """``x`` as numpy: a tensor is read back from its device; anything else
    goes through ``np.asarray``."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class SequentialAlexandridisCA:
    """Sequential per-cell Alexandridis fire CA (legacy prototype).

    ``update(grid, context)`` mutates nothing and returns ``(new_grid,
    context)`` as numpy, with ``context['fire_age']`` and
    ``context['wind_index']`` advanced.  ``context`` holds ``winds`` (8
    ``(wind_matrix, ft)`` pairs), ``wind_index``, ``vegetation``,
    ``density``, ``slope`` (one value a cell), ``fire_age``, ``p_tree`` and
    ``p_wind_change``.

    Its results cannot be reproduced by the batched ``AlexandridisCA`` even
    from matched draws: the skipped-cell pinecone rule makes each cell's
    update depend on the cells before it.
    """

    def __init__(self, empty: int = 0, tree: int = 1, fire: int = 2,
                 rng: np.random.Generator | None = None):
        self.empty, self.tree, self.fire = empty, tree, fire
        self.rng = rng if rng is not None else np.random.default_rng()

    # -- per-cell rules -------------------------------------------------------

    def _neighborhood(self, grid, row, col):
        """3x3 neighbourhood with out-of-bounds cells as ``empty``."""
        h, w = grid.shape
        out = np.full((3, 3), self.empty, grid.dtype)
        r0, r1 = max(0, row - 1), min(h, row + 2)
        c0, c1 = max(0, col - 1), min(w, col + 2)
        out[r0 - row + 1:r1 - row + 1, c0 - col + 1:c1 - col + 1] = grid[r0:r1, c0:c1]
        return out

    def _try_ignite(self, nb, row, col, new_grid, wind, ctx, fire_age):
        """Tree with a fire neighbour: burn iff some burning neighbour's
        directional probability wins its uniform roll."""
        p_veg = _VEG_BURN[int(ctx["vegetation"][row, col])]
        p_den = _DEN_BURN[int(ctx["density"][row, col])]
        slope = float(ctx["slope"][row, col])
        p_burn = _P_H * (1 + p_veg) * (1 + p_den) * wind * np.exp(_SLOPE_COEFF * slope)
        roll = self.rng.uniform(0.0, 1.0, p_burn.shape)
        if np.any((nb == self.fire) & (p_burn > roll)):
            new_grid[row, col] = self.fire
            fire_age[row, col] = self.rng.integers(4, 11)

    def _try_pinecone_ignite(self, row, col, new_grid, ctx, fire_age) -> bool:
        """Pinecone landing: a wind- and slope-free burn check with the
        boosted vegetation/density tables."""
        p_veg = _VEG_PINE[int(ctx["vegetation"][row, col])]
        p_den = _DEN_PINE[int(ctx["density"][row, col])]
        p_burn = _P_H * (1 + p_veg) * (1 + p_den)
        if p_burn > self.rng.uniform(0.0, 1.0):
            new_grid[row, col] = self.fire
            fire_age[row, col] = self.rng.integers(4, 11)
            return True
        return False

    # -- full pass ------------------------------------------------------------

    def update(self, grid, context):
        grid = _host(grid)
        h, w = grid.shape
        ctx = dict(context)
        for k in ("vegetation", "density", "slope"):
            ctx[k] = _host(ctx[k])
        wind, ft = ctx["winds"][int(ctx["wind_index"])]
        wind = _host(wind)
        ft = _host(ft)
        new_grid = grid.copy()
        fire_age = _host(ctx["fire_age"]).copy()
        p_tree = float(ctx["p_tree"])
        skipped: set = set()

        for row in range(h):
            for col in range(w):
                if (row, col) in skipped:
                    continue
                cell = grid[row, col]
                if cell == self.tree:
                    nb = self._neighborhood(grid, row, col)
                    if np.any(nb == self.fire):
                        self._try_ignite(nb, row, col, new_grid, wind, ctx, fire_age)
                elif cell == self.empty:
                    if self.rng.choice([True, False], p=[p_tree, 1 - p_tree]):
                        new_grid[row, col] = self.tree
                elif cell == self.fire:
                    fire_age[row, col] -= 1
                    if fire_age[row, col] == 0:
                        new_grid[row, col] = self.empty
                    # Pinecone spotting: a Poisson count, uniform directions,
                    # thrust 3 * N(0, 1) * ft[direction].
                    n_pine = int(self.rng.poisson())
                    if n_pine == 0:
                        continue
                    dirs = self.rng.integers(0, 8, size=n_pine)
                    thrust = 3.0 * self.rng.standard_normal(n_pine)
                    for i, d in enumerate(dirs):
                        t = thrust[i] * float(ft[_LOOKUP_GRID[d]])
                        nr = round(row + _DX[d] * t)
                        nc = round(col + _DY[d] * t)
                        if (0 <= nr < h and 0 <= nc < w and (nr, nc) != (row, col)):
                            if self._try_pinecone_ignite(nr, nc, new_grid, ctx, fire_age):
                                skipped.add((nr, nc))

        # Stochastic wind rotation.
        p_wc = float(ctx["p_wind_change"])
        if self.rng.choice([True, False], p=[p_wc, 1 - p_wc]):
            step = int(self.rng.integers(1, 8))
            ctx["wind_index"] = (int(ctx["wind_index"]) + step) % len(ctx["winds"])
        ctx["fire_age"] = fire_age
        return new_grid, ctx
