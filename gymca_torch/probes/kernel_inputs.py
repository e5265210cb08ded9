"""Inputs of the main paths' kernels, K1 and K2/K3, for checks and timings.

Shared by ``chip_smoke.py`` and :mod:`gymca_torch.probes.ab_parent`:

* synthetic inputs from a ``torch.Generator``, with the layouts that can
  break each kernel's tiling (fire on tile edges, tiles beside burning
  ones, fire only in a tile's halo, edits and shots on band seams);
* the main paths driven with random actions, and the kernel's inputs
  recorded at each launch (:func:`record_windy_launches`,
  :func:`record_alexandridis_launches`, or :func:`alexandridis_recorder`
  around any code that steps the Advanced env, such as the trainer);
* :func:`k1_work`, the bytes and operations K1 must move and do on given
  inputs (K2's count is ``alexandridis_kernel.alexandridis_work``).

Everything is made on ``device`` ("cuda" unless the caller says otherwise).
"""

from __future__ import annotations

import contextlib

import torch

from gymca_torch.ops.windy_kernel import CLUSTER_BLOCKS

__all__ = ["OPS_PER_CELL", "k1_work", "windy_inputs", "draw_actions", "run_steps",
           "record_windy_launches", "alexandridis_inputs", "alexandridis_keywords",
           "adv_actions", "adv_run", "alexandridis_recorder",
           "record_alexandridis_launches", "WINDY_CELLS",
           "K2_LAYOUTS"]

WINDY_CELLS = (0, 3, 25)  # empty, tree, fire of the windy env's grids
# Integer operations K1's function needs per cell of a CA env: two compares
# to classify the cell, two selects to write it back, and the word-parallel
# stencil (about 40 operations per 32-cell word, counted from the kernel).
OPS_PER_CELL = 4 + 40 / 32


def k1_work(grid, params, edit_counts, k):
    """Bytes K1 must move and integer operations it must do for one launch
    on these inputs, with the env classes counted: every env's params read
    (16 B) and counts written (12 B); a CA env's weights (32 B), edit count
    (4 B), its replayed edit words (4 B each) and its grid read and written
    once; a modify-only env's cell read and written.  Returns ``(bytes, ops,
    CA envs, modify-only envs, replayed edits)``."""
    n, h, w = grid.shape
    item = grid.element_size()
    ca = params[:, 0] > 0
    n_ca = int(ca.sum())
    n_mod = int((~ca & (params[:, 3] > 0)).sum())
    n_edits = int(edit_counts.clamp(0, k)[ca].sum())
    moved = (n * (16 + 12) + n_ca * (32 + 4 + 2 * h * w * item) + 4 * n_edits
             + n_mod * 2 * item)
    return moved, n_ca * h * w * OPS_PER_CELL, n_ca, n_mod, n_edits


def windy_inputs(n, h, w, dtype, k, gen, device="cuda", classes="mixed", seams=False):
    """K1 inputs: ``(grid, weights, params, edits, edit_counts)``.

    ``classes``: "mixed" (3 in 10 CA envs, some without fire, 3 in 10
    modify-only, the rest idle), or "ca", "modify" or "idle" for every env.
    Shots fall on trees and non-trees.  ``seams``: the CA pass's band seams
    (every ceil(h / CLUSTER_BLOCKS) rows) carry fire on both sides, and
    every edit and shot falls on a band's first or last row."""
    def rand(*shape, high):
        return torch.randint(0, high, shape, generator=gen, device=device)

    empty, tree, fire = WINDY_CELLS
    cell = rand(n, h, w, high=10)
    grid = torch.where(cell < 2, empty, torch.where(cell < 9, tree, fire))
    no_fire = rand(n, high=8) == 0
    grid = torch.where(no_fire[:, None, None] & (grid == fire), tree, grid)
    band = -(-h // CLUSTER_BLOCKS)
    if seams:
        rows = torch.arange(h, device=device)
        seam = ((rows % band == 0) | (rows % band == band - 1))[None, :, None]
        grid = torch.where(seam & (rand(n, h, w, high=3) == 0), fire, grid)
    grid = grid.to(dtype)
    cls = rand(n, high=10)  # 0-2 CA, 3-5 modify-only, rest idle
    if classes != "mixed":
        cls = torch.full_like(cls, {"ca": 0, "modify": 3, "idle": 9}[classes])
    do_ca = (cls < 3).to(torch.int32)
    shoot = ((cls < 6) & (rand(n, high=4) > 0)).to(torch.int32)

    def rows_of(*shape):
        r = rand(*shape, high=h)
        if seams:  # a band's first or last row
            r = (r // band) * band + (band - 1) * rand(*shape, high=2)
            r = r.clamp(max=h - 1)
        return r

    row, col = rows_of(n).to(torch.int32), rand(n, high=w).to(torch.int32)
    params = torch.stack([do_ca, row, col, shoot], dim=-1).contiguous()
    weights = (rand(n, 8, high=2) * 8).to(torch.int32)
    edits = (rows_of(n, k) | (rand(n, k, high=w) << 16)).to(torch.int32)
    edit_counts = rand(n, high=k + 1).to(torch.int32)
    return grid, weights, params, edits, edit_counts


def draw_actions(gen, steps, n, device="cuda"):
    """Random (steps, n, 2) int32 windy actions from one torch.randint launch."""
    r = torch.randint(0, 18, (steps, n), generator=gen, device=device)
    return torch.stack([r // 2, r % 2], dim=-1).to(torch.int32)


def run_steps(core, states, actions):
    for a in actions:
        states, out = core.step_batched(states, a)
    return states, out


def record_windy_launches(core, states, actions):
    """Step the windy main path and keep copies of K1's inputs at each
    launch: a list of ``(grid, weights, params, edits, edit_counts)``."""
    import gymca_torch.envs.bulldozer as bulldozer

    real = bulldozer.windy_fused_step
    recorded = []

    def recorder(grid, weights, params, edits, edit_counts, **kw):
        recorded.append(tuple(t.clone() for t in (grid, weights, params, edits,
                                                   edit_counts)))
        return real(grid, weights, params, edits, edit_counts, **kw)

    bulldozer.windy_fused_step = recorder
    try:
        run_steps(core, states, actions)
    finally:
        bulldozer.windy_fused_step = real
    return recorded


# Layouts of the synthetic K2 inputs, against the kernel's 32 x 64 tiles.
K2_LAYOUTS = ("random", "tile_edges", "checker_tiles", "halo_only", "all_fire", "no_fire")


def alexandridis_inputs(n, h, w, gen, device="cuda", layout="random", radius=None):
    """K2 inputs from a generator, and the env's keywords at that size
    (the radius of ``AlexandridisCA(h)``, or ``radius``): fires, dousing,
    terrain factors away from 1 and ages at and around 1.

    ``layout`` (one of ``K2_LAYOUTS``): "random" 10% fire and 75% trees;
    "tile_edges" fire only on the first and last row and column of each
    32 x 64 tile; "checker_tiles" the random layout in every other tile, the
    rest trees without fire; "halo_only" trees, with fire on rows 31 mod 64
    and columns 63 mod 128, so every other tile's only fire lies in its
    1-cell halo; "all_fire" and "no_fire"."""
    from gymca_torch.ops.alexandridis import AlexandridisCA

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    cells = rand(n, h, w)
    grid = torch.where(cells < 0.1, 2, torch.where(cells < 0.85, 1, 0))
    r = torch.arange(h, device=device)[:, None]
    c = torch.arange(w, device=device)[None, :]
    if layout == "tile_edges":
        edge = (r % 32 == 0) | (r % 32 == 31) | (c % 64 == 0) | (c % 64 == 63)
        grid = torch.where(edge & (cells < 0.3), 2, torch.where(cells < 0.85, 1, 0))
        grid = torch.where(~edge & (grid == 2), 1, grid)
    elif layout == "checker_tiles":
        grid = torch.where(((r // 32 + c // 64) % 2 == 1) & (grid == 2), 1, grid)
    elif layout == "halo_only":
        grid = torch.where((r % 64 == 31) | (c % 128 == 63), 2, 1).expand(n, h, w)
    elif layout == "all_fire":
        grid = torch.full_like(grid, 2)
    elif layout == "no_fire":
        grid = torch.where(grid == 2, 1, grid)
    elif layout != "random":
        raise ValueError(f"layout must be one of {K2_LAYOUTS}, got {layout!r}")
    ages = torch.tensor([0.5, 1.0, 1.5, 2.0, 60.0], device=device)
    x = dict(
        grid=grid.to(torch.int8).contiguous(),
        fire_age=ages[torch.randint(0, 5, (n, h, w), generator=gen, device=device)],
        dousing=(rand(n, h, w) < 0.05).to(torch.int8),
        vdf=(0.5 + 2.5 * rand(n, h, w)).to(torch.bfloat16),
        exp_slope=(0.8 + 0.45 * rand(n, 3, 3, h, w)).to(torch.bfloat16),
        wind_rows=0.5 + 3.5 * rand(n, 8),
        seeds=torch.randint(0, 2**32, (n, 2), generator=gen, device=device,
                            dtype=torch.int64),
    )
    return x, alexandridis_keywords(AlexandridisCA(h), radius)


def alexandridis_keywords(ca, radius=None):
    """The kernel's keywords for ``ca``, at its own radius or ``radius``."""
    from gymca_torch.ops.alexandridis import burn_kernel_layer_weights
    from gymca_torch.ops.stencil import telescoped_box_coeffs

    weights = ca.burn_layer_weights if radius is None else burn_kernel_layer_weights(radius)
    return dict(empty=ca.empty, tree=ca.tree, fire=ca.fire,
                layer_coeffs=telescoped_box_coeffs(weights),
                dousing_border=float(ca._dousing_border),
                dousing_inner=float(ca._dousing_inner),
                fire_age_min=int(ca.fire_age_min), fire_age_max=int(ca.fire_age_max))


def adv_actions(gen, steps, n, device="cuda"):
    """Random (steps, n, 3) int32 Advanced actions (move 0-8, shoot 0-1,
    extension 0) from one torch.randint launch."""
    r = torch.randint(0, 18, (steps, n), generator=gen, device=device)
    return torch.stack([r // 2, r % 2, torch.zeros_like(r)], dim=-1).to(torch.int32)


def adv_run(env, obs, info, actions):
    """``stateless_step`` then ``conditional_reset`` per action; returns the
    last observation and info and the last ``stateless_step`` tuple."""
    for a in actions:
        step = env.stateless_step(a, obs, info)
        reset = env.conditional_reset(step, a)
        obs, info = reset[0], reset[4]
    return obs, info, step


@contextlib.contextmanager
def alexandridis_recorder(keep=None):
    """While open, keep copies of the Advanced env's kernel inputs at each
    launch whose index (0 for the first launch inside the block) is in
    ``keep``, or at every launch if ``keep`` is None.  Yields the list of
    ``(x, kw)`` it fills."""
    import gymca_torch.envs.advanced as advanced

    real = advanced.alexandridis_fused_step
    recorded, seen = [], [0]

    def recorder(*args, **kw):
        if keep is None or seen[0] in keep:
            names = ("grid", "fire_age", "dousing", "vdf", "exp_slope", "wind_rows", "seeds")
            recorded.append(({k: t.clone() for k, t in zip(names, args)}, kw))
        seen[0] += 1
        return real(*args, **kw)

    advanced.alexandridis_fused_step = recorder
    try:
        yield recorded
    finally:
        advanced.alexandridis_fused_step = real


def record_alexandridis_launches(env, obs, info, actions):
    """Step the Advanced path and keep copies of the kernel's inputs at each
    launch: a list of ``(x, kw)``."""
    with alexandridis_recorder() as recorded:
        adv_run(env, obs, info, actions)
    return recorded
