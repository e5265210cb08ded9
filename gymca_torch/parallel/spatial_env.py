"""Whole env steps on grids cut into row bands.

Counterpart of ``gymca_tpu/parallel/spatial_env.py``.  Each rank holds its
band of every grid; a step runs the CA on the band with its halos
(``gymca_torch.parallel.spatial``), lands the agent's cell write on the rank
that owns the agent's row, and sums the tree, fire and hit counts over the
band group with one ``all_reduce`` to give every rank the global reward and
termination.  The gust rolls come from the per-env key chain, which every
rank carries whole, so :func:`bulldozer_step_spatial` equals
``BulldozerCore.step`` bit for bit on any number of bands, and the batched
step on any ``(data, space)`` mesh.

:func:`advanced_step_spatial` does the same for the Alexandridis physics:
the sharded CA (:func:`~gymca_torch.parallel.spatial.alexandridis_bands`),
then Move, the dousing write on the owning band (which the JAX package
leaves to XLA's partitioner), the day/night clock and the reward from the
summed counts.  It is headless: no RGB observation is rendered.

States are batched, as everywhere in the port: ``bulldozer_step_spatial``
steps ``N`` envs (one, for one huge grid) whose grids are all cut into bands
over one axis; the ``*_batched_spatial`` steps take a rank's block of a
``(data, space)`` mesh, ``N / d`` envs each cut into ``H / s`` rows.  Data
ranks exchange nothing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gymca_torch import rng
from gymca_torch.config import TYPE_BOX, TYPE_INT
from gymca_torch.core.env import EnvState, StepOutput, tree_map
from gymca_torch.envs.bulldozer import BulldozerCore, derive_step_key
from gymca_torch.ops.move_modify import DEFAULT_DIRECTIONS, Move, move_position
from gymca_torch.ops.repeat_ca import modf
from gymca_torch.ops.windy import windy_step_from_success
from gymca_torch.parallel.mesh import axis_rank, axis_size
from gymca_torch.parallel.spatial import alexandridis_bands, exchange_row_halos, shard_rows

__all__ = ["shard_state", "bulldozer_step_spatial", "shard_state_batched",
           "bulldozer_step_batched_spatial", "advanced_step_batched_spatial",
           "advanced_step_spatial"]


def shard_state(state: EnvState, mesh, axis: str = "data") -> EnvState:
    """This rank's part of a batched state whose grids are cut into row
    bands over ``mesh[axis]``: every leaf shaped like ``state.grid``
    ``(N, H, W)`` keeps its band of rows; the rest is kept whole."""
    shape = state.grid.shape
    return tree_map(lambda x: shard_rows(x, mesh, axis, dim=1)
                    if isinstance(x, torch.Tensor) and x.shape == shape else x, state)


def shard_state_batched(states, mesh, *, data_axis: str = "data",
                        space_axis: str = "space"):
    """This rank's block of a batch on a ``(data, space)`` mesh.

    ``states`` is an ``EnvState`` or a dict of per-env tensors (the Advanced
    env's ``per_env_context``, with its ``true_grid``), whose grids have H
    rows.  Leaves ``(N, H, ...)`` are cut over ``data`` on the env axis and
    over ``space`` on the rows; ``exp_slope`` ``(N, 3, 3, H, W)`` likewise, rows on its axis 3
    (``P(data, None, None, space, None)``); any other leaf whose first
    dimension divides by the data size over ``data`` alone; the rest is
    kept whole.
    """
    d = axis_size(mesh, data_axis)
    di = axis_rank(mesh, data_axis)
    rows = (states.grid if isinstance(states, EnvState) else states["true_grid"]).shape[1]

    def envs(x):
        per = x.shape[0] // d
        return x[di * per:(di + 1) * per]

    def place(x):
        if not isinstance(x, torch.Tensor) or x.dim() < 1 or x.shape[0] % d or x.shape[0] < d:
            return x
        if x.dim() >= 3 and x.shape[1] == rows:
            return shard_rows(envs(x), mesh, space_axis, dim=1)
        if x.dim() == 5 and x.shape[1:3] == (3, 3) and x.shape[3] == rows:
            return shard_rows(envs(x), mesh, space_axis, dim=3)
        return envs(x)

    return tree_map(place, states)


def _owned(position, group, rows: int):
    """The local row of each env's ``position`` and whether this rank's band
    holds it."""
    local = position[..., 0] - dist.get_rank(group) * rows
    return local.clamp(0, rows - 1).long(), (local >= 0) & (local < rows)


def _bulldozer_bands(core: BulldozerCore, states: EnvState, actions, group):
    """The Bulldozer step of ``N`` envs whose grids are ``(N, rows, W)``
    bands over ``group`` (``BulldozerCore.step_batched``'s semantics: the
    same key threading, RepeatCA timing, post-CA Modify and count-based
    reward), every write made here at once, so the edit log rides along
    untouched."""
    n_bands = dist.get_world_size(group)
    grid = states.grid
    n, rows, w = grid.shape
    h = rows * n_bands
    if (h, w) != (core.nrows, core.ncols):
        raise ValueError(f"{n_bands} bands of {tuple(grid.shape)} do not make the core's "
                         f"{core.nrows} x {core.ncols} grids")
    if core.repeater.max_repeats != 1:
        raise ValueError("the spatial step covers the one-CA-per-step regime (all big grids)")

    was_done = states.done
    live = ~was_done
    carry_keys, rolls = derive_step_key(states.key)
    success = core._wind > rolls  # every rank draws the same gust per env
    a_move = actions[..., 0].long()
    a_shoot = actions[..., 1].long()
    time_taken = core._move_timings[a_move] + core._shoot_timings[a_shoot] + core._t_any
    frac, repeats = modf(states.context["time"] + time_taken)
    do_ca = (repeats >= 1.0) & live
    new_position = move_position(states.context["position"], a_move, h, w,
                                 core.move.drow, core.move.dcol)
    shoot = (a_shoot > 0) & live

    empty, tree, fire = core._empty, core._tree, core._fire
    extended = exchange_row_halos(grid, group, empty, dim=1)
    ca = windy_step_from_success(extended, success, empty=empty, tree=tree,
                                 fire=fire)[:, 1:-1]
    new_grid = torch.where(do_ca[:, None, None], ca, grid)

    # Modify: the write lands on the band holding the agent's row.
    env = torch.arange(n, device=grid.device)
    r, owned = _owned(new_position, group, rows)
    c = new_position[..., 1].long()
    cell = new_grid[env, r, c]
    hit_here = owned & shoot & (cell == tree)
    new_grid[env, r, c] = torch.where(hit_here, empty, cell).to(grid.dtype)

    counts = torch.stack([hit_here.to(torch.int64), (new_grid == tree).sum((1, 2)),
                          (new_grid == fire).sum((1, 2))])
    dist.all_reduce(counts, group=group)
    hit = torch.where(was_done, states.context["hit"], counts[0] > 0)
    t_i = torch.where(was_done, states.context["tree_count"], counts[1].to(TYPE_INT))
    f_i = torch.where(was_done, states.context["fire_count"], counts[2].to(TYPE_INT))
    t = counts[1].to(TYPE_BOX)
    f = counts[2].to(TYPE_BOX)
    zero = torch.zeros((), dtype=TYPE_BOX, device=t.device)
    reward = torch.where(was_done, zero, -(f / torch.clamp(t + f, min=1.0)))
    done = was_done | (f == 0.0)

    context = dict(states.context)
    context.update(
        position=torch.where(was_done[:, None], states.context["position"], new_position),
        time=torch.where(was_done, states.context["time"], frac.to(TYPE_BOX)),
        hit=hit, tree_count=t_i, fire_count=f_i)
    new_states = EnvState(
        grid=new_grid, context=context, key=carry_keys, done=done,
        steps_elapsed=states.steps_elapsed + live.to(TYPE_INT),
        reward_accumulated=states.reward_accumulated + reward)
    out = StepOutput(obs=core.observe(new_states), reward=reward, terminated=done,
                     truncated=torch.zeros_like(done), info={"hit": hit})
    return new_states, out


def bulldozer_step_spatial(core: BulldozerCore, state: EnvState, action, mesh, *,
                           axis: str = "data"):
    """One full Bulldozer step of envs whose grids are cut into row bands
    over ``mesh[axis]`` (:func:`shard_state`): one halo row a side for the
    stencil, the agent's write on the owning band, the global counts from
    one all-reduce.  Equals ``core.step`` of the whole grids bit for bit."""
    return _bulldozer_bands(core, state, action, mesh.get_group(axis))


def bulldozer_step_batched_spatial(core: BulldozerCore, states: EnvState, actions, mesh, *,
                                   data_axis: str = "data", space_axis: str = "space"):
    """Batch x space: this rank's block of a batch on a ``(data, space)``
    mesh (:func:`shard_state_batched`), ``N / d`` envs of ``H / s`` rows each,
    stepped with the halos of all its envs in one exchange and the counts
    summed over ``space_axis`` alone.  Equals ``core.step`` of the whole
    batch bit for bit on any mesh shape."""
    return _bulldozer_bands(core, states, actions, mesh.get_group(space_axis))


_MOVE_TABLES: dict = {}


def _move_tables(device):
    """``DEFAULT_DIRECTIONS``' (drow, dcol) tables on ``device``, made once a
    device and copied there without waiting: a table copied from the host on
    every step would wait for it."""
    if device not in _MOVE_TABLES:
        move = Move(DEFAULT_DIRECTIONS, device="cpu")
        _MOVE_TABLES[device] = (move.drow.to(device, non_blocking=True),
                                move.dcol.to(device, non_blocking=True))
    return _MOVE_TABLES[device]


def _advanced_epilogue(ca, grids, new_fire_age, per_envs, shared, actions, k_carry, group,
                       t_eps):
    """Move, the dousing write on the owning band, the day/night clock and
    the reward from the counts summed over ``group``."""
    n, rows, w = grids.shape
    h = rows * dist.get_world_size(group)
    position = move_position(per_envs["position"], actions[:, 0], h, w,
                             *_move_tables(grids.device))

    new = dict(per_envs)
    new["fire_age"] = new_fire_age
    new["position"] = position
    dousing = per_envs["dousing_count"].clone()
    env = torch.arange(n, device=grids.device)
    r, owned = _owned(position, group, rows)
    c = position[:, 1].long()
    douse = owned & (actions[:, 1] == 1)
    dousing[env, r, c] = torch.where(douse, 1, dousing[env, r, c]).to(dousing.dtype)
    new["dousing_count"] = dousing
    new["true_grid"] = grids
    new["time_step"] = per_envs["time_step"] + 1
    new["is_night"] = torch.where(new["time_step"] % shared["day_length"] == 0,
                                  1 - per_envs["is_night"], per_envs["is_night"])
    new["key"] = k_carry

    counts = torch.stack([(grids == ca.tree).sum((1, 2)), (grids == ca.fire).sum((1, 2))])
    dist.all_reduce(counts, group=group)
    t, f = counts.to(TYPE_BOX)
    return new, -(f / (t + f + t_eps)), f == 0


def advanced_step_batched_spatial(ca, grids, per_envs: dict, shared: dict, actions, keys,
                                  mesh, *, data_axis: str = "data", space_axis: str = "space",
                                  t_eps: float = 1e-8):
    """Batch x space for the Alexandridis physics: this rank's block of
    ``N`` Advanced envs on a ``(data, space)`` mesh (``grids`` ``(N/d, H/s,
    W)``, ``per_envs`` cut by :func:`shard_state_batched`, ``actions`` and
    ``keys`` this rank's envs').  Headless, as :func:`advanced_step_spatial`;
    returns ``(new_grids, new_per_envs, rewards, dones)``, each env equal to
    :func:`advanced_step_spatial` of it alone on ``s`` bands."""
    group = mesh.get_group(space_axis)
    pair = rng.split(keys)
    k_ca, k_carry = pair[:, 0], pair[:, 1]
    new_grids, new_fire_age = alexandridis_bands(ca, grids, per_envs, shared, k_ca, group)
    new, rewards, dones = _advanced_epilogue(ca, new_grids, new_fire_age, per_envs, shared,
                                             actions, k_carry, group, t_eps)
    return new_grids, new, rewards, dones


def advanced_step_spatial(ca, band, per_env: dict, shared: dict, action, key, mesh, *,
                          axis: str = "data", t_eps: float = 1e-8):
    """One headless Advanced-physics step of one env whose grid is cut into
    row bands over ``mesh[axis]``: the sharded Alexandridis CA, Move, the
    dousing write on the owning band, the time step and day/night flip, and
    reward ``-f / (t + f + eps)`` and done from the global counts.  ``band``
    ``(H/D, W)``; ``per_env`` one env's context with this rank's band of
    each ``(H, ...)`` entry.  The caller owns wind rotation.  Returns
    ``(new_band, new_per_env, reward, done)``."""
    one = {k: v[None] if isinstance(v, torch.Tensor) else v for k, v in per_env.items()}
    grids, new, rewards, dones = advanced_step_batched_spatial(
        ca, band[None], one, shared, action[None], key[None], mesh, space_axis=axis,
        t_eps=t_eps)
    return grids[0], {k: v[0] if isinstance(v, torch.Tensor) else v
                      for k, v in new.items()}, rewards[0], dones[0]
