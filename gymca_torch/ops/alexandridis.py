"""Alexandridis-et-al.-2008 wildfire CA with hidden terrain, over a batch of
envs: the physics of the Advanced Bulldozer env.

Counterpart of ``gymca_tpu/ops/alexandridis.py`` (the XLA path):

* burn probability ``p = (heat - dousing) * (1+p_veg) * (1+p_den) * wind *
  exp(0.078 * slope)`` with the vegetation/density tables ``VEG_PROBS`` /
  ``DEN_PROBS``;
* ``heat`` = ring-decayed kernel of radius ``ceil(log2(N)) - 2`` over the
  fire mask, as telescoped box sums;
* dousing retardant = two-level 5x5 box sum over ``dousing_count``;
* ignition from one uniform per cell against ``1 - prod_d max(1 - p_d, 0)``;
* new fires get ages in ``[fire_age_min, fire_age_max)``; fires burn out at
  age <= 1; burning fires age by one;
* stochastic wind-index rotation with probability ``p_wind_change``;
* optional pinecone spotting (``enable_pinecones``, off by default): every
  fire cell lofts up to ``max_pinecones`` embers along wind-scaled normal
  flights, and an ember lights the tree it lands on.

Every draw comes from the same ``gymca_torch.rng`` key chain as the JAX
package, so the update equals it bit for bit.  The landings follow XLA's
CPU scatter: every ember of every cell writes its landing cell, the unlit
ones with the value already there, and where several land on one cell the
last in the JAX package's slot-major order wins.  The port picks that entry
with a max-reduction of entry indices per cell, which is deterministic on
the card too (``index_put_`` on duplicate indices is not ordered there).

``AlexandridisCA.sequential_prototype`` builds the legacy sequential spec
(``gymca_torch.ops.alexandridis_legacy``).
"""

from __future__ import annotations

import functools
import math

import torch

from gymca_torch import rng
from gymca_torch.config import TYPE_BOX
from gymca_torch.core.operator import Operator
from gymca_torch.envs.terrain import xla_exp
from gymca_torch.ops.stencil import (
    NEIGHBOR_OFFSETS,
    multi_box_sums,
    ring_kernel_filter,
    shift,
)

__all__ = ["AlexandridisCA", "build_burn_kernel", "burn_kernel_layer_weights",
           "build_dousing_weights", "VEG_PROBS", "DEN_PROBS", "SLOPE_COEFF"]

# Vegetation / density factor tables; index 0 is a -999 sentinel.
VEG_PROBS = (-999.0, -0.1, 0.2, 0.5, 0.8, 1.2)
DEN_PROBS = (-999.0, -0.2, 0.2, 0.5, 0.8, 1.2)
SLOPE_COEFF = 0.078  # 'a' in exp(a * slope)
# Pinecone compass, counter-clockwise from East in array coords (drow, dcol).
COMPASS = ((1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1))
# 0.48 as the bfloat16 it becomes beside a bfloat16 operand in JAX.
_PINECONE_BURN = float(torch.tensor(0.48, dtype=torch.bfloat16))


@functools.lru_cache(maxsize=8)
def _compass(device: torch.device):
    """The compass's row and column steps, int32 (8,) each, on ``device``:
    copied there once, so a step makes no host-to-device copy."""
    table = torch.tensor(COMPASS, dtype=torch.int32).to(device)
    return table[:, 0].contiguous(), table[:, 1].contiguous()


def burn_kernel_layer_weights(burn_kernel_radius: int) -> list:
    """Per-ring weights of the heat kernel: total weight 0.065; each ring
    takes 60% of the remaining weight spread over its cells (the innermost
    ring also covers the centre), the last ring takes what is left."""
    total_weight = 0.065
    num_layers = burn_kernel_radius
    layer_weights = []
    remaining = total_weight
    for i in range(num_layers):
        size_outer = (i * 2 + 3) ** 2
        inner_area = (i * 2 + 1) ** 2
        cells = size_outer - inner_area
        if i == 0:
            cells += 1  # the centre shares the innermost ring's weight
        if i == num_layers - 1:
            layer_weights.append(remaining / cells)
        else:
            layer_weights.append(remaining * 0.60 / cells)
            remaining *= 0.40
    return layer_weights


def build_burn_kernel(burn_kernel_radius: int, device=None) -> torch.Tensor:
    """Dense (2r+1)^2 heat kernel, the oracle of the ring/box form."""
    layer_weights = burn_kernel_layer_weights(burn_kernel_radius)
    size = 2 * burn_kernel_radius + 1
    k = torch.zeros((size, size), dtype=TYPE_BOX, device=device)
    center = burn_kernel_radius
    k[center, center] = layer_weights[0]
    for i, w in enumerate(layer_weights):
        ring = i + 1
        s, e = center - ring, center + ring + 1
        k[s:e, s] = w
        k[s:e, e - 1] = w
        k[s, s:e] = w
        k[e - 1, s:e] = w
    return k


def build_dousing_weights(fire_age_max: float, device=None) -> torch.Tensor:
    """5x5 retardant kernel: border/inner weights scaled by the max fire age."""
    border = 0.0007 * fire_age_max * 0.50
    inner = 0.006 * fire_age_max * 0.50
    k = torch.full((5, 5), border, dtype=TYPE_BOX, device=device)
    k[1:4, 1:4] = inner
    return k


class AlexandridisCA(Operator):
    """Partially observable wildfire CA over hidden terrain.

    ``update(grid, action, (per_env_context, shared_context), keys)`` ->
    ``(new_grid, (new_per_env_context, shared_context))`` for a batch:
    ``grid`` (N, H, W), every per-env entry with a leading N, ``keys``
    (N, 2) key data.
    """

    grid_dependant = True
    action_dependant = False
    context_dependant = True
    deterministic = False

    def __init__(
        self,
        grid_size: int,
        empty: int = 0,
        tree: int = 1,
        fire: int = 2,
        enable_pinecones: bool = False,
        max_pinecones: int = 5,
        static_p_tree: float = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.grid_size = grid_size
        self.empty, self.tree, self.fire = empty, tree, fire
        self.enable_pinecones = enable_pinecones
        self.max_pinecones = max_pinecones
        # p_tree statically 0 (the Advanced default): empty cells never grow,
        # so the growth draw and branch are skipped.
        self.skip_growth = static_p_tree == 0.0

        self.initial_spread_time = grid_size + grid_size // 2
        self.fire_age_min = int(self.initial_spread_time * 1.5)
        self.fire_age_max = int(self.initial_spread_time * 1.75)
        self.burn_kernel_radius = max(math.ceil(math.log2(max(grid_size, 4))) - 2, 1)
        self.burn_layer_weights = burn_kernel_layer_weights(self.burn_kernel_radius)
        # two-level 5x5 dousing kernel as box sums:
        # border * box_2 + (inner - border) * box_1
        self._dousing_border = 0.0007 * self.fire_age_max * 0.50
        self._dousing_inner = 0.006 * self.fire_age_max * 0.50

    @staticmethod
    def sequential_prototype(empty: int = 0, tree: int = 1, fire: int = 2, rng=None):
        """The legacy sequential per-cell prototype (NumPy, one env,
        order-dependent pinecone semantics): a behavioural spec run on the
        host, not a device path.  ``rng`` is a ``np.random.Generator``."""
        from gymca_torch.ops.alexandridis_legacy import SequentialAlexandridisCA

        return SequentialAlexandridisCA(empty, tree, fire, rng=rng)

    # --- pieces ------------------------------------------------------------

    def _ignitions(self, grid, base, wind_matrix, exp_slope, keys):
        """Tree cells ignited by any fire neighbour passing its directional
        burn test: one uniform per cell against the complement product
        ``1 - prod_d max(1 - p_d, 0)``.

        ``base`` (N, H, W); ``wind_matrix`` (N, 3, 3); ``exp_slope``
        (N, 3, 3, H, W), direction-major; ``keys`` (N, 2).
        """
        h, w = grid.shape[-2:]
        u = rng.uniform(keys, (h, w))
        no_ignite = torch.ones_like(base)
        for dr, dc in NEIGHBOR_OFFSETS:
            fire_there = shift(grid, dr, dc, self.empty) == self.fire
            p = (base * wind_matrix[:, 1 + dr, 1 + dc, None, None]
                 * exp_slope[:, 1 + dr, 1 + dc].float())
            no_ignite = no_ignite * torch.clamp(
                1.0 - torch.where(fire_there, p, 0.0), min=0.0)
        return u < 1.0 - no_ignite

    @staticmethod
    def precompute_exp_slope(slope: torch.Tensor) -> torch.Tensor:
        """(..., H, W, 3, 3) float32 slope -> (..., 3, 3, H, W) bfloat16
        ``exp(0.078 * slope)``, direction-major.  Stored in bfloat16: a static
        factor near 1 that the kernel streams once per step."""
        moved = slope.movedim((-2, -1), (-4, -3)).contiguous()
        return xla_exp(SLOPE_COEFF * moved).to(torch.bfloat16)

    @staticmethod
    def precompute_veg_den_factor(vegetation, density) -> torch.Tensor:
        """Static per-cell ``(1 + p_veg) * (1 + p_den)`` in bfloat16."""
        veg = torch.tensor(VEG_PROBS, dtype=TYPE_BOX, device=vegetation.device)
        den = torch.tensor(DEN_PROBS, dtype=TYPE_BOX, device=density.device)
        p_veg = veg[torch.clamp(vegetation, 1, 5).long()]
        p_den = den[torch.clamp(density, 1, 5).long()]
        return ((1.0 + p_veg) * (1.0 + p_den)).to(torch.bfloat16)

    def _veg_den_factor(self, per_env) -> torch.Tensor:
        """The env's factor, computed once from its static terrain, or, for
        direct operator use, the factor of the context's terrain."""
        vdf = per_env.get("veg_den_factor")
        if vdf is None:
            vdf = self.precompute_veg_den_factor(per_env["vegetation"], per_env["density"])
        return vdf

    def _pinecone_spread(self, grid, keys, per_env, ft, fire_mask):
        """Pinecone spotting: every fire cell lofts ``min(Poisson(1),
        max_pinecones)`` embers; each flies ``normal * thrust`` cells along
        one of the 8 compass directions and lights a tree where it lands
        with probability ``0.48 * veg_den_factor`` there.

        Slot-major, as the JAX package: one (H, W) layer of draws per ember
        slot.  The d-th compass direction takes its thrust from the d-th
        off-centre cell of ``ft`` in row-major order (the reference's
        pairing).  ``grid`` and ``fire_mask`` (N, H, W), ``keys`` (N, 2),
        ``ft`` (N, 3, 3).  Returns the landing rows, columns and lit flags of
        every entry, each (N, max_pinecones * H * W), slot-major."""
        n, h, w = grid.shape
        dev = grid.device
        rows = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
        cols = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
        comp_r, comp_c = _compass(dev)
        thrust = torch.stack([ft[:, 1 + dr, 1 + dc] for dr, dc in NEIGHBOR_OFFSETS],
                             dim=-1).to(TYPE_BOX)  # (N, 8)
        burn_p = (_PINECONE_BURN * self._veg_den_factor(per_env)).reshape(n, h * w)
        flat_grid = grid.reshape(n, h * w)

        pair = rng.split(keys)
        k_count, k_slots = pair[:, 0], pair[:, 1]
        n_embers = rng.poisson(k_count, 1.0, (h, w), max_count=self.max_pinecones)

        land_r, land_c, lit = [], [], []
        for slot in range(self.max_pinecones):
            sub = rng.split(rng.fold_in(k_slots, slot), 3)
            d = rng.randint(sub[:, 0], (h, w), 0, 8).long()
            flight = rng.normal(sub[:, 1], (h, w)) * thrust.gather(
                1, d.reshape(n, -1)).reshape(n, h, w)
            # compass steps are -1, 0 or 1: each product is exact
            r = torch.clamp(torch.round(rows + comp_r[d] * flight), 0, h - 1).to(torch.int32)
            c = torch.clamp(torch.round(cols + comp_c[d] * flight), 0, w - 1).to(torch.int32)
            in_flight = fire_mask & (slot < n_embers)
            u = rng.uniform(sub[:, 2], (h, w))
            at = (r.long() * w + c).reshape(n, -1)
            lit.append(in_flight & (flat_grid.gather(1, at).reshape(n, h, w) == self.tree)
                       & (u < burn_p.gather(1, at).reshape(n, h, w)))
            land_r.append(r)
            land_c.append(c)
        return (torch.stack(land_r, 1).reshape(n, -1), torch.stack(land_c, 1).reshape(n, -1),
                torch.stack(lit, 1).reshape(n, -1))

    def _land_pinecones(self, grid, fire_age, rows, cols, lit, ages):
        """``grid.at[rows, cols].set(where(lit, fire, grid[rows, cols]))`` and
        the same for ``fire_age`` with ``ages``, per env, as XLA's CPU
        scatter orders duplicates: the last entry landing on a cell decides
        it, lit or not."""
        n, h, w = grid.shape
        at = rows.long() * w + cols
        order = torch.arange(at.shape[1], device=at.device).expand_as(at)
        last = torch.full((n, h * w), -1, dtype=torch.int64, device=at.device)
        last = last.scatter_reduce(1, at, order, reduce="amax")
        pick = last.clamp(min=0)
        lights = (last >= 0) & lit.gather(1, pick)
        new_grid = torch.where(lights, self.fire, grid.reshape(n, -1)).to(grid.dtype)
        new_age = torch.where(lights, ages.gather(1, pick).to(fire_age.dtype),
                              fire_age.reshape(n, -1))
        return new_grid.reshape(n, h, w), new_age.reshape(n, h, w)

    # --- main update ---------------------------------------------------------

    def update(self, grid, action, context, keys=None):
        per_env, shared = context
        wind_index = per_env["wind_index"].long()
        wind_matrix = shared["winds"][wind_index]

        sub = rng.split(keys, 6)
        k_burn, k_grow, k_age, k_wchange, k_widx, k_pine = (sub[:, i] for i in range(6))

        tree_mask = grid == self.tree
        fire_mask = grid == self.fire
        empty_mask = grid == self.empty

        heat = ring_kernel_filter(fire_mask.to(TYPE_BOX), self.burn_layer_weights)
        dbox = multi_box_sums(per_env["dousing_count"].to(TYPE_BOX), (1, 2))
        dousing_ret = (self._dousing_border * dbox[2]
                       + (self._dousing_inner - self._dousing_border) * dbox[1])
        base = (heat - dousing_ret) * self._veg_den_factor(per_env).float()
        exp_slope = per_env.get("exp_slope")
        if exp_slope is None:  # direct operator use
            exp_slope = self.precompute_exp_slope(per_env["slope"])
        ignite = self._ignitions(grid, base, wind_matrix, exp_slope, k_burn)

        new_fire_ages = rng.randint(k_age, grid.shape[-2:], self.fire_age_min,
                                    self.fire_age_max).to(per_env["fire_age"].dtype)

        if self.skip_growth:
            grown = grid
        else:
            u_grow = rng.uniform(k_grow, grid.shape[-2:])
            grown = torch.where(empty_mask & (u_grow < shared["p_tree"]),
                                self.tree, grid)
        new_grid = torch.where(
            tree_mask & ignite, self.fire,
            torch.where(fire_mask & (per_env["fire_age"] <= 1), self.empty, grown),
        ).to(grid.dtype)

        new_fire_age = torch.where((new_grid == self.fire) & (grid != self.fire),
                                   new_fire_ages, per_env["fire_age"])

        if self.enable_pinecones:
            ft = shared["fts"][wind_index]
            rows, cols, burn = self._pinecone_spread(new_grid, k_pine, per_env, ft, fire_mask)
            pinecone_ages = rng.randint(rng.fold_in(k_pine, 1), burn.shape[1:], 4, 11)
            new_grid, new_fire_age = self._land_pinecones(new_grid, new_fire_age, rows, cols,
                                                          burn, pinecone_ages)
        # Burning fires age.
        new_fire_age = torch.where(fire_mask, new_fire_age - 1, new_fire_age)

        # Stochastic wind rotation.
        wind_change = rng.uniform(k_wchange) < shared["p_wind_change"]
        n_winds = shared["winds"].shape[0]
        new_wind_index = torch.where(
            wind_change,
            (per_env["wind_index"] + rng.randint(k_widx, (), 1, 8)) % n_winds,
            per_env["wind_index"],
        ).to(per_env["wind_index"].dtype)

        new_per_env = dict(per_env)
        new_per_env["fire_age"] = new_fire_age
        new_per_env["wind_index"] = new_wind_index
        return new_grid, (new_per_env, shared)
