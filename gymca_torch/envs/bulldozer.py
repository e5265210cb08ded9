"""ForestFireBulldozer — the windy wildfire-control task over a batch of envs.

Counterpart of ``gymca_tpu/envs/bulldozer.py``:

* cells ``0/3/25 = empty/tree/fire``;
* wind dict -> 3x3 propagation-probability matrix;
* initial grid ~ p_tree=0.90 / p_empty=0.10 with one fire seed around the
  lower-left quadrant (+1/12-axis noise) and the bulldozer around the
  upper-right, drawn from the same key chain as the JAX package;
* time model ``t_any=0.001``, ``t_move=(1/(speed_move*scale))-t_any``,
  ``t_shoot=(1/(speed_act*scale))-t_move``, not_move/none costing 0;
* MDP = RepeatCA(windy) then MoveModify;
* reward ``-(f/(t+f))``; terminates when no fire remains.

``BulldozerCore.step`` is the eager batched step (the counterpart of
``jax.vmap(core.step)``); ``step_batched`` is the fast path through kernel
K1 (``gymca_torch.ops.windy_kernel``).  ``ForestFireBulldozerEnv``, the
gymnasium env, lives in ``gymca_torch.gym_env`` and is loaded from there
only when asked for.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from gymca_torch import rng
from gymca_torch.config import TYPE_BOX, TYPE_INT, resolve_device
from gymca_torch.core.env import CAEnvCore, EnvState, StepOutput
from gymca_torch.core.operator import Operator
from gymca_torch.core.spaces import BoxSpec, GridSpec, MultiDiscreteSpec, TupleSpec
from gymca_torch.ops.move_modify import (
    DEFAULT_DIRECTIONS,
    Modify,
    Move,
    MoveModify,
    move_position,
)
from gymca_torch.ops.repeat_ca import RepeatCA, modf
from gymca_torch.ops.windy import WindyForestFire
from gymca_torch.ops.windy_kernel import windy_fused_step, windy_weights_from_roll
from gymca_torch.utils.metrics import span

__all__ = ["BulldozerCore", "BulldozerMDP", "ForestFireBulldozerEnv", "DEFAULT_WIND",
           "parse_wind", "derive_step_key", "default_grid_dtype"]


def derive_step_key(keys: torch.Tensor):
    """The per-step key threading of ``CAEnvCore.step`` -> MDP -> RepeatCA ->
    windy uniform, for the fused path: ``(N, 2)`` keys ->
    ``(carry_keys, rolls)`` with ``rolls`` the ``(N, 3, 3)`` gust samples the
    eager step draws."""
    pair = rng.split(keys)
    carry, sub = pair[..., 0, :], pair[..., 1, :]
    k_ca = rng.split(sub)[..., 0, :]
    k0 = rng.split(k_ca, 1)[..., 0, :]
    return carry, rng.uniform(k0, (3, 3))


DEFAULT_WIND = {
    "up_left": 0.48,
    "up": 0.64,
    "up_right": 0.98,
    "left": 0.12,
    "right": 0.64,
    "down_left": 0.06,
    "down": 0.12,
    "down_right": 0.48,
}


def parse_wind(wind: dict, device=None) -> torch.Tensor:
    """Wind dict -> 3x3 float32 matrix on ``device`` (the card unless the
    caller names another); raises on values outside [0, 1]."""
    mat = torch.tensor(
        [
            [wind["up_left"], wind["up"], wind["up_right"]],
            [wind["left"], 0.0, wind["right"]],
            [wind["down_left"], wind["down"], wind["down_right"]],
        ],
        dtype=TYPE_BOX,
    )
    if not bool(((mat >= 0.0) & (mat <= 1.0)).all()):
        raise ValueError("Bad Wind Data, check ranges [0.0, 1.0]")
    return mat.to(resolve_device(device))


def default_grid_dtype(nrows: int, ncols: int) -> torch.dtype:
    """The JAX package's default grid dtype for these dimensions, so that the
    same constructor arguments give the same dtype: int8, unless the grid
    tiles a TPU only at int32's (8, 128) tile and not at int8's (32, 128)
    (``gymca_tpu/envs/bulldozer.py`` and ``supports_sparse_kernel``)."""

    def tiles(itemsize: int) -> bool:
        tile_r = {4: 8, 1: 32}[itemsize]
        return (nrows % tile_r == 0 and ncols % 128 == 0 and nrows >= tile_r
                and ncols >= 128 and nrows * ncols * itemsize <= 8 * 1024 * 1024)

    return torch.int8 if tiles(1) or not tiles(4) else torch.int32


class BulldozerMDP(Operator):
    """RepeatCA then MoveModify; the context is a dict
    {wind, position, time, hit, pos_fire, tree_count, fire_count, edit_log,
    edit_count} of (N, ...) tensors."""

    grid_dependant = True
    action_dependant = True
    context_dependant = True
    deterministic = False

    def __init__(self, repeat_ca: RepeatCA, move_modify: MoveModify, tree: int,
                 fire: int, **kwargs):
        super().__init__(**kwargs)
        self.repeat_ca = repeat_ca
        self.move_modify = move_modify
        self.tree, self.fire = tree, fire
        self.suboperators = (repeat_ca, move_modify)

    def update(self, grid, action, context, keys=None):
        k_ca = rng.split(keys)[..., 0, :]
        grid, (wind, time) = self.repeat_ca(
            grid, action, (context["wind"], context["time"]), k_ca
        )
        grid, (position, hit) = self.move_modify(grid, action, context["position"])
        return grid, {
            "wind": wind,
            "position": position,
            "time": time,
            "hit": hit,
            "pos_fire": context["pos_fire"],  # episode constant
            "tree_count": (grid == self.tree).sum(dim=(-2, -1)).to(TYPE_INT),
            "fire_count": (grid == self.fire).sum(dim=(-2, -1)).to(TYPE_INT),
            # Modify writes land in the grid at once here, so the deferred-
            # edit log is threaded through untouched.
            "edit_log": context["edit_log"],
            "edit_count": context["edit_count"],
        }


class BulldozerCore(CAEnvCore):
    """Functional windy-Bulldozer core over a batch of envs.

    Runs on ``device``: the card unless the caller names another; without a
    CUDA device, ``device=None`` raises.
    """

    def __init__(
        self,
        nrows: int,
        ncols: int,
        speed_move: float = 0.12,
        speed_act: float = 0.03,
        pos_bull: Optional[Tuple[int, int]] = None,
        pos_fire: Optional[Tuple[int, int]] = None,
        t_move: Optional[float] = None,
        t_shoot: Optional[float] = None,
        t_any: float = 0.001,
        p_tree: float = 0.90,
        p_empty: float = 0.10,
        wind: dict = None,
        grid_dtype=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.nrows, self.ncols = nrows, ncols
        self.title = f"ForestFireBulldozer{nrows}x{ncols}"

        self._grid_dtype = (default_grid_dtype(nrows, ncols) if grid_dtype is None
                            else grid_dtype)
        self._empty, self._tree, self._fire = 0, 3, 25
        self._pos_bull = pos_bull
        self._pos_fire = pos_fire
        self._p_tree = p_tree
        self._p_empty = p_empty
        self._wind = parse_wind(wind or DEFAULT_WIND, self.device)
        self._effects = {self._tree: self._empty}

        scale = (nrows + ncols) // 2
        self._t_env_any = t_any
        self._t_act_none = 0.0
        self._t_act_move = (1 / (speed_move * scale)) - t_any if t_move is None else t_move
        self._t_act_shoot = (
            (1 / (speed_act * scale)) - self._t_act_move if t_shoot is None else t_shoot
        )

        # Timing tables: not_move (4) and no-shoot (0) cost nothing.
        move_t = [self._t_act_move] * 9
        move_t[4] = self._t_act_none
        shoot_t = [self._t_act_none, self._t_act_shoot]
        self._move_timings = torch.tensor(move_t, dtype=TYPE_BOX, device=self.device)
        self._shoot_timings = torch.tensor(shoot_t, dtype=TYPE_BOX, device=self.device)
        self._t_any = torch.tensor(t_any, dtype=TYPE_BOX, device=self.device)

        # The carried fraction is < 1, so repeats per step is at most
        # floor(1 + max_step_time).
        max_step_time = self._t_act_move + self._t_act_shoot + t_any
        max_repeats = max(int(math.floor(1.0 + max_step_time)), 1)

        # Deferred-edit log capacity: each step that logs an edit advances
        # accu_time by at least delta = t_shoot + t_any without crossing a CA
        # period, so at most floor(1/delta) edits wait for the next CA
        # application; +1 headroom, capped at 64.  A full log falls back to
        # the kernel's modify-only class.
        delta = self._t_act_shoot + t_any
        self._edit_log_k = (
            0 if delta <= 0 else min(int(math.floor(1.0 / delta)) + 1, 64)
        )

        def t_acting(action):
            return (self._move_timings[action[..., 0].long()]
                    + self._shoot_timings[action[..., 1].long()])

        def t_perception(state):
            return self._t_any

        self._set_specs()

        self.ca = WindyForestFire(self._empty, self._tree, self._fire)
        self.move = Move(DEFAULT_DIRECTIONS, device=self.device)
        self.modify = Modify(self._effects, device=self.device)
        self.move_modify = MoveModify(self.move, self.modify)
        self.repeater = RepeatCA(
            self.ca, t_acting, t_perception, max_repeats=max_repeats, mode="modf"
        )
        self._mdp = BulldozerMDP(self.repeater, self.move_modify, self._tree, self._fire)

    def _set_specs(self):
        nrows, ncols = self.nrows, self.ncols
        self.grid_spec = GridSpec(
            values=(self._empty, self._tree, self._fire), shape=(nrows, ncols),
            dtype=self._grid_dtype,
        )
        self.ca_params_spec = BoxSpec(0.0, 1.0, shape=(3, 3))
        self.position_spec = MultiDiscreteSpec((nrows, ncols))
        self.time_spec = BoxSpec(0.0, float("inf"), shape=())
        self.context_spec = TupleSpec(
            (self.ca_params_spec, self.position_spec, self.time_spec)
        )
        self.action_spec = MultiDiscreteSpec((9, 2))
        self.observation_spec = TupleSpec((self.grid_spec, self.context_spec))

    @property
    def mdp(self):
        return self._mdp

    # --- initial state ---------------------------------------------------------

    def _noise(self, keys, ax_len: int):
        """1/12-axis placement noise, one draw per key."""
        upper = int(ax_len * (1 / 12))
        if upper <= 0:
            return torch.zeros(keys.shape[:-1], dtype=TYPE_INT, device=keys.device)
        return rng.randint(keys, (), 0, upper)

    def initial_state(self, keys: torch.Tensor) -> EnvState:
        """Initial states of ``len(keys)`` envs from ``(N, 2)`` key data."""
        keys = keys.to(self.device)
        n = keys.shape[0]
        sub = rng.split(keys, 6)
        k_grid, k_fire_r, k_fire_c, k_bull_r, k_bull_c, k_carry = (
            sub[:, i] for i in range(6))
        grid_spec = GridSpec(
            values=(self._empty, self._tree, self._fire),
            probs=(self._p_empty, self._p_tree, 0.0),
            shape=(self.nrows, self.ncols),
            dtype=self._grid_dtype,
        )
        grid = grid_spec.sample(k_grid)

        def full(v):
            return torch.full((n,), int(v), dtype=TYPE_INT, device=self.device)

        if self._pos_fire is None:
            fr = 3 * self.nrows // 4 + self._noise(k_fire_r, self.nrows)
            fc = 1 * self.ncols // 4 + self._noise(k_fire_c, self.ncols)
        else:
            fr, fc = full(self._pos_fire[0]), full(self._pos_fire[1])
        env = torch.arange(n, device=self.device)
        grid[env, fr.long(), fc.long()] = self._fire

        if self._pos_bull is None:
            br = 1 * self.nrows // 4 + self._noise(k_bull_r, self.nrows)
            bc = 3 * self.ncols // 4 + self._noise(k_bull_c, self.ncols)
        else:
            br, bc = full(self._pos_bull[0]), full(self._pos_bull[1])

        context = {
            "wind": self._wind.expand(n, 3, 3).clone(),
            "position": torch.stack([br, bc], dim=-1).to(TYPE_INT),
            "time": torch.zeros((n,), dtype=TYPE_BOX, device=self.device),
            "hit": torch.zeros((n,), dtype=torch.bool, device=self.device),
            "pos_fire": torch.stack([fr, fc], dim=-1).to(TYPE_INT),
            "tree_count": (grid == self._tree).sum(dim=(1, 2)).to(TYPE_INT),
            "fire_count": (grid == self._fire).sum(dim=(1, 2)).to(TYPE_INT),
            # Write-back log of deferred Modify cell writes (step_batched
            # only; the eager step keeps it empty): row | col << 16 words,
            # entries [0, edit_count) pending.
            "edit_log": torch.zeros((n, self._edit_log_k), dtype=torch.int32,
                                    device=self.device),
            "edit_count": torch.zeros((n,), dtype=torch.int32, device=self.device),
        }
        return EnvState(
            grid=grid,
            context=context,
            key=k_carry,
            done=torch.zeros((n,), dtype=torch.bool, device=self.device),
            steps_elapsed=torch.zeros((n,), dtype=TYPE_INT, device=self.device),
            reward_accumulated=torch.zeros((n,), dtype=TYPE_BOX, device=self.device),
        )

    # --- reward / termination / report -----------------------------------------

    def observe(self, state: EnvState):
        c = state.context
        return state.grid, (c["wind"], c["position"], c["time"])

    def _award(self, grid, context):
        """-(f / (t + f)) from the counts the MDP keeps in the context."""
        t = context["tree_count"].to(TYPE_BOX)
        f = context["fire_count"].to(TYPE_BOX)
        return -(f / torch.clamp(t + f, min=1.0))

    def _is_done(self, grid, context):
        return context["fire_count"] == 0

    def _report(self, grid, context):
        return {"hit": context["hit"]}

    # --- fused batched step (kernel K1) ----------------------------------------

    def supports_fused_step(self) -> bool:
        """K1 covers the one-CA-application-per-step regime
        (``max_repeats == 1``, true for all registered grid sizes).  Grids
        whose step can span several CA periods take the eager step."""
        return self.repeater.max_repeats == 1

    @span("step_batched")
    def step_batched(self, states: EnvState, actions: torch.Tensor):
        """Batched step over N envs through kernel K1.

        Same outputs as :meth:`step` (the eager batched step, counterpart of
        ``jax.vmap(step)``) bit for bit: same key derivation, same integer
        stencil, same float32 reward.  Grids with ``max_repeats > 1`` take
        :meth:`step` itself.  On the card nothing here waits for the device.

        Modify's single-cell writes are DEFERRED into a bounded per-env log
        (``context['edit_log']``) and replayed into the grid at the env's next
        CA application, before the stencil.  Between CA applications
        ``states.grid`` is stale at the logged cells: call
        :meth:`materialize_grid` before reading grids as observations.

        ``states.grid`` is updated IN PLACE and returned as the new state's
        grid (the reference aliases the kernel's grid in -> out); clone the
        states first to keep them.
        """
        if not self.supports_fused_step():
            return self.step(states, actions)

        carry_keys, rolls = derive_step_key(states.key)

        was_done = states.done
        live = ~was_done
        a_move = actions[..., 0].long()
        a_shoot = actions[..., 1].long()

        # RepeatCA timing (max_repeats == 1), in the reference's float32 order.
        time_taken = (self._move_timings[a_move] + self._shoot_timings[a_shoot]
                      + self._t_any)
        frac, repeats = modf(states.context["time"] + time_taken)
        do_ca = (repeats >= 1.0) & live

        new_position = move_position(
            states.context["position"], a_move, self.nrows, self.ncols,
            self.move.drow, self.move.dcol,
        )

        weights = windy_weights_from_roll(self._wind, rolls)
        shoot = a_shoot.to(TYPE_INT) * live.to(TYPE_INT)

        # Modify resolution: a modify-only env hits iff its target cell is a
        # tree AND no pending logged edit already emptied that cell.
        K = self._edit_log_k
        log = states.context["edit_log"]
        log_cnt = states.context["edit_count"]
        n = states.grid.shape[0]
        env_ids = torch.arange(n, device=states.grid.device)
        r_i = new_position[..., 0]
        c_i = new_position[..., 1]
        rowcol = r_i | (c_i << 16)
        cur = states.grid[env_ids, r_i.long(), c_i.long()].to(torch.int32)
        is_modify = ~do_ca & (shoot > 0)
        if K:
            kidx = torch.arange(K, dtype=torch.int32, device=log.device)[None, :]
            valid = kidx < log_cnt[:, None]
            pending = ((log == rowcol[:, None]) & valid).any(dim=-1)
        else:
            pending = torch.zeros((n,), dtype=torch.bool, device=log.device)
        hit_mod = is_modify & (cur == self._tree) & ~pending
        can_log = hit_mod & (log_cnt < K)
        overflow = hit_mod & ~can_log

        # Kernel classes: CA envs (shot handled in-kernel on the new grid) and
        # modify-only envs (edit-log overflow only).
        params = torch.stack(
            [
                do_ca.to(TYPE_INT),
                r_i,
                c_i,
                torch.where(do_ca, shoot, overflow.to(TYPE_INT)),
            ],
            dim=-1,
        ).to(torch.int32)

        new_grid, counts = windy_fused_step(
            states.grid, weights, params, log, log_cnt,
            empty=self._empty, tree=self._tree, fire=self._fire,
        )

        # Log update, after the kernel consumed the old log: CA envs replayed
        # and clear it; modify envs append their hit unless it overflowed
        # (the kernel wrote that cell at once).
        if K:
            onehot = (kidx == log_cnt[:, None]) & can_log[:, None]
            new_log = torch.where(
                do_ca[:, None], 0, torch.where(onehot, rowcol[:, None], log)
            ).to(torch.int32)
            new_log_cnt = torch.where(do_ca, 0, log_cnt + can_log.to(torch.int32)
                                      ).to(torch.int32)
        else:
            new_log, new_log_cnt = log, log_cnt

        # Kernel counts hold only where it did CA work; skipped and modify
        # envs carry theirs from the context.
        hit_now = torch.where(do_ca, counts[..., 2] > 0, hit_mod)
        hit_i = hit_mod.to(TYPE_INT)
        t_i = torch.where(do_ca, counts[..., 0],
                          states.context["tree_count"] - hit_i).to(TYPE_INT)
        f_i = torch.where(do_ca, counts[..., 1],
                          states.context["fire_count"]).to(TYPE_INT)
        t = t_i.to(TYPE_BOX)
        f = f_i.to(TYPE_BOX)
        # done envs keep their frozen (stale) hit flag, as step's freeze does
        hit = torch.where(was_done, states.context["hit"], hit_now)

        zero = torch.zeros((), dtype=TYPE_BOX, device=t.device)
        reward = torch.where(was_done, zero, -(f / torch.clamp(t + f, min=1.0)))
        done = was_done | (f == 0.0)

        new_context = {
            "wind": states.context["wind"],
            "position": torch.where(was_done[..., None], states.context["position"],
                                    new_position),
            "time": torch.where(was_done, states.context["time"], frac.to(TYPE_BOX)),
            "hit": hit,
            "pos_fire": states.context["pos_fire"],
            "tree_count": t_i,
            "fire_count": f_i,
            "edit_log": new_log,
            "edit_count": new_log_cnt,
        }
        new_states = EnvState(
            grid=new_grid,
            context=new_context,
            key=carry_keys,
            done=done,
            steps_elapsed=states.steps_elapsed + live.to(TYPE_INT),
            reward_accumulated=states.reward_accumulated + reward,
        )
        out = StepOutput(
            obs=self.observe(new_states),
            reward=reward,
            terminated=done,
            truncated=torch.zeros_like(done),
            info={"hit": hit},
        )
        return new_states, out

    def materialize_grid(self, states: EnvState) -> torch.Tensor:
        """Grids with the pending deferred Modify writes flushed in: equal to
        what :meth:`step` would have produced.  Returns a new tensor."""
        K = self._edit_log_k
        grid = states.grid.clone()
        if K == 0:
            return grid
        log, cnt = states.context["edit_log"], states.context["edit_count"]
        env = torch.arange(grid.shape[0], device=grid.device)
        for k in range(K):
            wrd = log[:, k]
            r, c = (wrd & 0xFFFF).long(), (wrd >> 16).long()
            grid[env, r, c] = torch.where(k < cnt, self._empty, grid[env, r, c])
        return grid


def __getattr__(name):
    if name == "ForestFireBulldozerEnv":  # imports gymnasium: loaded on demand
        from gymca_torch.gym_env import ForestFireBulldozerEnv

        return ForestFireBulldozerEnv
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
