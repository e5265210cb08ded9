"""AdvancedForestFireBulldozer — the batched, partially observable
wildfire-control env.

Counterpart of ``gymca_tpu/envs/advanced.py``:

* batched over ``num_envs`` with cells ``0/1/2 = empty/tree/fire``;
* hidden terrain (vegetation / density / altitude / slope / rotating wind)
  driving the Alexandridis CA; ``use_hidden`` toggles random-patch versus
  uniform terrain;
* dousing: shooting marks ``dousing_count[pos] = 1``, which lowers the burn
  probability around it;
* day/night flips every ``day_length = 400`` steps; with extensions on,
  daytime observations are blurred and extension channels are bought through
  a combinatorial action id;
* observation = RGB-rendered grid (day/night palettes, dousing tint, agent
  pixel) + the context, ``obs = (rgb, context)`` as nested dicts of tensors
  keyed as the JAX package's pytree;
* API: ``reset()``, ``stateless_step(action, obs, info)``,
  ``conditional_reset(step_tuple, action)``;
* reward ``-(f / (t + f + 1e-8))`` per env; done = no fire;
* ``render(obs, info, env_idx)`` and the terrain heatmaps
  (``altitude_render``, ``density_render``, ``vegitation_render``), host-side
  matplotlib (``gymca_torch.utils.render``).

The CA runs one of two ways (``use_fused_ca``, the JAX package's
``use_pallas_ca``):

* fused: one launch per step of the hand-written CUDA kernel
  ``gymca_torch.ops.alexandridis_kernel.alexandridis_fused_step`` (its plain
  torch version for CPU tensors), with the JAX package's key chain around it
  and the kernel's own per-cell draws inside;
* the XLA-path counterpart: ``AlexandridisCA`` over the batch, every draw
  from the JAX package's key chain, bit for bit; with ``enable_pinecones``
  it also spots pinecones, and the env always takes this path then.

Every step runs on the device with no host synchronisation.  In particular
``conditional_reset`` always runs its merge instead of testing
``terminated.any()`` on the host, as the JAX package's ``lax.cond`` does:
with no env terminated every merge is a ``where`` on an all-false mask and
the result equals the untouched step tuple.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Tuple

import torch

from gymca_torch import rng
from gymca_torch.config import TYPE_BOX, TYPE_INT, resolve_device
from gymca_torch.core.spaces import GridSpec, MultiDiscreteSpec
from gymca_torch.envs import terrain as terrain_mod
from gymca_torch.envs.extensions import (
    EXTENSION_REGISTRY,
    apply_extensions,
    extension_choices,
    transform_grid,
)
from gymca_torch.ops.alexandridis import AlexandridisCA
from gymca_torch.ops.alexandridis_kernel import alexandridis_fused_step
from gymca_torch.ops.move_modify import DEFAULT_DIRECTIONS, ModifyDousing, Move
from gymca_torch.ops.repeat_ca import modf
from gymca_torch.ops.stencil import NEIGHBOR_OFFSETS, telescoped_box_coeffs
from gymca_torch.utils.metrics import span

__all__ = ["AdvancedForestFireBulldozerEnv", "TERRAIN_KEYS"]

# Day palette
COLOR_EMPTY_DAY = (221, 209, 211)  # "#DDD1D3" gray
COLOR_TREE_DAY = (169, 196, 153)  # "#A9C499" green
COLOR_FIRE_DAY = (230, 129, 129)  # "#E68181" salmon-red
# Night palette
COLOR_EMPTY_NIGHT = (105, 105, 105)  # "#696969"
COLOR_TREE_NIGHT = (47, 79, 79)  # "#2F4F4F"
COLOR_FIRE_NIGHT = (139, 0, 0)  # "#8B0000"
WATER_TINT_DAY = (0.0, 0.0, 200.0)
WATER_TINT_NIGHT = (255.0, 165.0, 0.0)

TERRAIN_KEYS = ("density", "vegetation", "altitude", "slope", "exp_slope",
                "veg_den_factor")


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """An (N,) mask shaped to broadcast over ``like``'s per-env entries."""
    return mask.reshape(mask.shape + (1,) * (like.ndim - 1))


class AdvancedForestFireBulldozerEnv:
    """Batched functional env.  Runs on ``device``: the card unless the
    caller names another; without a CUDA device ``device=None`` raises.

    ``key`` is ``(2,)`` key data (``gymca_torch.rng.key(seed)``).  The
    terrain is drawn from it as the JAX package draws it, or passed in as
    ``terrain``, a dict of the six tensors of ``TERRAIN_KEYS``.

    ``use_fused_ca``: ``None`` runs the fused kernel on a CUDA device and
    the XLA-path counterpart on the CPU (what the JAX package runs there);
    ``True`` runs the kernel, or its plain version on the CPU; ``False``
    runs the XLA-path counterpart.  ``True`` with ``ca_repeat_mode="modf"``
    or with pinecones warns and runs the XLA-path counterpart, as the JAX
    package does: the kernel covers one CA application per step and no
    pinecone spotting.  The kernel has no tile
    alignment or size gate, so, for example, at 64x64 the port runs fused
    where the JAX package runs its XLA path.
    """

    PER_ENV_CONTEXT_KEYS = {
        "wind_index", "density", "vegetation", "altitude", "slope", "exp_slope",
        "veg_den_factor", "fire_age", "key", "is_night", "true_grid", "time_step",
        "dousing_count",
    }
    SHARED_CONTEXT_KEYS = {"winds", "fts", "p_fire", "p_tree", "p_wind_change",
                           "day_length"}

    def __init__(
        self,
        nrows: int,
        ncols: int,
        key: torch.Tensor,
        num_envs: int = 8,
        speed_move: float = 0.12,
        speed_act: float = 0.03,
        speed_multiplier: float = 1.0,
        pos_bull: Optional[Tuple[int, int]] = None,
        pos_fire: Optional[Tuple[int, int]] = None,
        t_move: Optional[float] = None,
        t_shoot: Optional[float] = None,
        t_any: float = 0.001,
        p_tree: float = 0.90,
        p_empty: float = 0.10,
        use_hidden: bool = True,
        middle_fire: bool = False,
        enable_extensions: bool = False,
        enable_pinecones: bool = False,
        ca_repeat_mode: str = "single",
        use_fused_ca: Optional[bool] = None,
        obs_dtype=torch.uint8,
        terrain: Optional[dict] = None,
        device=None,
        **kwargs,
    ):
        self.device = dev = resolve_device(device)
        if ca_repeat_mode not in ("single", "modf"):
            raise ValueError(f"ca_repeat_mode must be 'single' or 'modf', got "
                             f"{ca_repeat_mode!r}")
        supported = ca_repeat_mode == "single" and not enable_pinecones
        if use_fused_ca is None:
            use_fused_ca = dev.type == "cuda" and supported
        self.use_fused_ca = bool(use_fused_ca) and supported
        if use_fused_ca and not self.use_fused_ca:
            warnings.warn(
                "use_fused_ca requested but unsupported for this config "
                f"(nrows={nrows}, ncols={ncols} — the kernel covers one CA "
                "application a step and no pinecone spotting — "
                f"ca_repeat_mode={ca_repeat_mode!r}, "
                f"enable_pinecones={enable_pinecones}); "
                "falling back to the XLA CA path",
                stacklevel=2,
            )
        if obs_dtype not in (torch.uint8, torch.float32):
            raise ValueError(f"obs_dtype must be torch.uint8 or torch.float32, got "
                             f"{obs_dtype}")
        self._obs_dtype = obs_dtype

        self.nrows, self.ncols = nrows, ncols
        self.num_envs = num_envs
        self.title = f"ForestFireBulldozer{nrows}x{ncols}"
        self.speed_multiplier = speed_multiplier
        self.middle_fire = middle_fire
        self.use_hidden = use_hidden
        self.enable_extensions = enable_extensions
        self.starting_key = key.to(dev)
        self.ca_repeat_mode = ca_repeat_mode

        self._empty, self._tree, self._fire = 0, 1, 2
        self._p_tree_init = p_tree
        self._p_empty_init = p_empty
        self._p_fire = 0.00033
        self._p_tree = 0.0
        self._p_wind_change = 0.06
        self._day_length = 400

        # --- terrain (drawn once per env instance) ----------------------------
        self._winds, self._fts = terrain_mod.get_winds(use_hidden, dev)
        if terrain is None:
            terrain = self._draw_terrain(self.starting_key)
        elif set(terrain) != set(TERRAIN_KEYS):
            raise ValueError(f"terrain must hold exactly {TERRAIN_KEYS}, got "
                             f"{sorted(terrain)}")
        self._terrain_ctx = {k: terrain[k].to(dev) for k in TERRAIN_KEYS}

        # --- time model ---------------------------------------------------------
        # speed_multiplier scales the agent's speed against the fire's; 1.0
        # keeps the reference's timings.  not_move and no-shoot cost the
        # full move/shoot time.
        scale = (nrows + ncols) // 2
        self._t_env_any = t_any
        self._t_act_move = ((1 / (speed_move * speed_multiplier * scale)) - t_any
                            if t_move is None else t_move)
        self._t_act_shoot = ((1 / (speed_act * speed_multiplier * scale))
                             - self._t_act_move if t_shoot is None else t_shoot)
        self._move_timings = torch.full((9,), self._t_act_move, dtype=TYPE_BOX,
                                        device=dev)
        self._shoot_timings = torch.full((2,), self._t_act_shoot, dtype=TYPE_BOX,
                                         device=dev)
        self._max_repeats = int(
            math.ceil(self._t_act_move + self._t_act_shoot + t_any)) + 1

        # --- operators ------------------------------------------------------------
        self.ca = AlexandridisCA(nrows, self._empty, self._tree, self._fire,
                                 enable_pinecones=enable_pinecones,
                                 static_p_tree=self._p_tree)
        self.move = Move(DEFAULT_DIRECTIONS, device=dev)
        self.modify_dousing = ModifyDousing()
        self._layer_coeffs = telescoped_box_coeffs(self.ca.burn_layer_weights)

        # --- extension action mapping --------------------------------------------
        self.extension_choices = extension_choices()
        self._extension_lookups = [
            terrain_mod.create_up_to_k_mappings(n, k, dev)[0]
            for n, k in self.extension_choices
        ]
        self._set_spaces()

        # --- constants of the step, on the device, built once ---------------------
        def table(rows, dtype):
            return torch.tensor(rows, dtype=dtype, device=dev)

        day = (COLOR_EMPTY_DAY, COLOR_TREE_DAY, COLOR_FIRE_DAY)
        night = (COLOR_EMPTY_NIGHT, COLOR_TREE_NIGHT, COLOR_FIRE_NIGHT)
        self._palettes = {dt: (table(day, dt), table(night, dt))
                          for dt in (TYPE_BOX, torch.int32)}
        self._water = {dt: (table(WATER_TINT_DAY, dt), table(WATER_TINT_NIGHT, dt))
                       for dt in (TYPE_BOX, torch.int32)}
        self._shared = {
            "winds": self._winds,
            "fts": self._fts,
            "p_fire": table(self._p_fire, TYPE_BOX),
            "p_tree": table(self._p_tree, TYPE_BOX),
            "p_wind_change": table(self._p_wind_change, TYPE_BOX),
            "day_length": table(self._day_length, TYPE_INT),
        }
        # Fresh-state constants: the initial grid's distribution, the fire
        # seed and the bulldozer's start.
        self._init_grid_spec = GridSpec(
            values=(self._empty, self._tree, self._fire),
            probs=(self._p_empty_init, self._p_tree_init, 0.0),
            shape=(nrows, ncols), dtype=torch.int8)
        if pos_fire is not None:
            self._fire_rc = tuple(pos_fire)
        elif middle_fire:
            self._fire_rc = (nrows // 2, ncols // 2)
        else:
            self._fire_rc = (3 * nrows // 4, ncols // 4)
        self._initial_fire_age = (nrows + nrows // 2) * 2
        bull = pos_bull if pos_bull is not None else (int(nrows * 0.15),
                                                      int(ncols * 0.85))
        self._init_position = table(bull, TYPE_INT)

    # ------------------------------------------------------------------ spaces

    def _set_spaces(self):
        """Per-env specs; every entry point takes a leading batch of
        ``num_envs``."""
        m, n = 9, 2
        self.action_space = MultiDiscreteSpec((m, n))
        extension_nvec = tuple(sum(math.comb(nn, i) for i in range(k + 1))
                               for nn, k in self.extension_choices)
        self.extension_space = MultiDiscreteSpec(
            tuple(math.comb(nn, k) for nn, k in self.extension_choices))
        self.total_action_space = MultiDiscreteSpec((m, n) + extension_nvec)
        self.grid_spec = GridSpec(values=(self._empty, self._tree, self._fire),
                                  shape=(self.num_envs, self.nrows, self.ncols, 3))
        self.per_env_context_keys = self.PER_ENV_CONTEXT_KEYS
        self.shared_context_keys = self.SHARED_CONTEXT_KEYS

    # --------------------------------------------------------------- terrain

    def _draw_terrain(self, key) -> dict:
        """The terrain bundle of ``self.num_envs`` envs from ``key``, as the
        JAX package draws it."""
        h, w, n = self.nrows, self.ncols, self.num_envs
        sub = rng.split(key, 4)
        k_veg, k_den, k_alt = sub[1], sub[2], sub[3]
        if self.use_hidden:
            density = terrain_mod.init_density(k_den, h, w, n)
            vegetation = terrain_mod.init_vegetation(k_veg, h, w, n)
            altitude, slope = terrain_mod.init_altitude_and_slope(k_alt, h, w, n)
        else:
            density = terrain_mod.init_density_same(h, w, n, self.device)
            vegetation = terrain_mod.init_vegetation_same(h, w, n, self.device)
            altitude = terrain_mod.init_altitude_same(h, w, n, self.device)
            slope = terrain_mod.get_slope(altitude)
        return {
            "density": density,
            "vegetation": vegetation,
            "altitude": altitude,
            "slope": slope,
            "exp_slope": AlexandridisCA.precompute_exp_slope(slope),
            "veg_den_factor": AlexandridisCA.precompute_veg_den_factor(vegetation,
                                                                       density),
        }

    # --------------------------------------------------------------- initial state

    @span("fresh_state")
    def _initial_per_env_state(self, keys):
        """Fresh ``(cell_grid int8, fire_age, position)`` for ``len(keys)``
        envs, one per key."""
        k_grid = rng.split(keys)[:, 0]
        grid = self._init_grid_spec.sample(k_grid)
        fr, fc = self._fire_rc
        grid[:, fr, fc] = self._fire
        grid[:, fr, fc - 1] = self._fire
        fire_age = torch.zeros(grid.shape, dtype=TYPE_BOX, device=grid.device)
        fire_age[:, fr, fc] = self._initial_fire_age
        fire_age[:, fr, fc - 1] = self._initial_fire_age
        position = self._init_position.expand(keys.shape[0], 2).clone()
        return grid, fire_age, position

    def _shared_context(self):
        return dict(self._shared)

    def initial_state(self, key=None, terrain=None):
        """Batched initial ``(grid_stack, context)``, a function of ``key``."""
        key = self.starting_key if key is None else key.to(self.device)
        terrain = terrain if terrain is not None else self._terrain_ctx
        pair = rng.split(key)
        k_winds, k_envs = pair[0], pair[1]
        env_keys = rng.split(k_envs, self.num_envs)
        grids, fire_ages, positions = self._initial_per_env_state(env_keys)
        n = self.num_envs
        if self.use_hidden:
            wind_index = rng.randint(k_winds, (n,), 0, 8)
        else:
            wind_index = torch.zeros((n,), dtype=TYPE_INT, device=self.device)
        per_env_context = {
            "wind_index": wind_index,
            **terrain,
            "fire_age": fire_ages,
            "key": rng.fold_in(env_keys, 1),
            "is_night": torch.zeros((n,), dtype=TYPE_INT, device=self.device),
            "true_grid": grids,
            "time_step": torch.ones((n,), dtype=TYPE_INT, device=self.device),
            "dousing_count": torch.zeros_like(grids, dtype=torch.int8),
        }
        context = {
            "per_env_context": per_env_context,
            "shared_context": self._shared_context(),
            "position": positions,
            "time": torch.zeros((n,), dtype=TYPE_BOX, device=self.device),
        }
        zeros = torch.zeros(grids.shape, dtype=TYPE_BOX, device=self.device)
        grid_stack = torch.stack([grids.to(TYPE_BOX), zeros, zeros], dim=-1)
        return grid_stack, context

    def reset(self, key=None):
        """``(obs, info)`` of fresh envs: ``obs = (rgb, context)``."""
        grid_stack, context = self.initial_state(key)
        per_env = context["per_env_context"]
        rgb = self.grid_to_rgb_with_extensions(grid_stack, per_env, context["position"])
        n = self.num_envs

        def zeros(dtype):
            return torch.zeros((n,), dtype=dtype, device=self.device)

        info = {
            "TimeLimit.truncated": zeros(torch.bool),
            "terminated": zeros(torch.bool),
            "steps_elapsed": zeros(TYPE_BOX),
            "reward_accumulated": zeros(TYPE_BOX),
            "reward": zeros(TYPE_BOX),
        }
        return (rgb, context), info

    # ------------------------------------------------------------------- actions

    def _create_full_actions(self, action):
        """(N, 2 + n_registries) combinatorial ids -> (N, 2 + total_ext)
        binary bits, int32."""
        expected = 2 + len(self._extension_lookups)
        if action.shape[-1] != expected:
            raise ValueError(
                f"action must have {expected} columns (move, shoot, "
                f"{len(self._extension_lookups)} extension id(s)); got shape "
                f"{tuple(action.shape)}")
        action = action.to(TYPE_INT)
        parts = [action[:, :2]] + [lookup[action[:, 2 + i].long()]
                                   for i, lookup in enumerate(self._extension_lookups)]
        return torch.cat(parts, dim=-1)

    # --------------------------------------------------------------- observation

    def _grid_to_rgb(self, display_grid, is_night, dousing_count, position):
        """Palette render + dousing tint + agent pixel, (N, H, W) ->
        (N, H, W, 3) of the obs dtype.

        In uint8 mode the whole pipeline runs in integer math: the palettes
        and tints are integers and the only blend is 0.25/0.75, so
        ``round(rgb*0.25 + water*0.75)`` (half to even) equals the fixed
        point ``q + (r == 3) + (r == 2 and q odd)`` of ``v = rgb + 3*water``.
        """
        idx = torch.clamp(display_grid.to(TYPE_INT), 0, 2)
        h, w = idx.shape[-2:]
        dev = idx.device
        at_pos = ((torch.arange(h, device=dev)[None, :, None] == position[:, 0, None, None])
                  & (torch.arange(w, device=dev)[None, None, :]
                     == position[:, 1, None, None]))[..., None]
        night = (is_night > 0)[:, None, None]
        if self._obs_dtype == torch.uint8:
            day_pal, night_pal = self._palettes[torch.int32]
            day_w, night_w = self._water[torch.int32]
            palette = torch.where(night, night_pal, day_pal)  # (N, 3, 3)
            water = torch.where(night[:, 0], night_w, day_w)  # (N, 3)
            rgb = torch.zeros(idx.shape + (3,), dtype=torch.int32, device=dev)
            for v in range(3):
                rgb = torch.where((idx == v)[..., None], palette[:, None, None, v], rgb)
            v = rgb + 3 * water[:, None, None]
            q, r = v >> 2, v & 3
            blended = q + (r == 3) + ((r == 2) & ((q & 1) == 1))
            rgb = torch.where((dousing_count == 1)[..., None], blended, rgb)
            return torch.where(at_pos, 0, rgb).to(torch.uint8)
        day_pal, night_pal = self._palettes[TYPE_BOX]
        day_w, night_w = self._water[TYPE_BOX]
        palette = torch.where(night, night_pal, day_pal)
        rgb = torch.zeros(idx.shape + (3,), dtype=TYPE_BOX, device=dev)
        for v in range(3):
            rgb = torch.where((idx == v)[..., None], palette[:, None, None, v], rgb)
        strength = torch.where(dousing_count == 1, 0.75, 0.0).to(TYPE_BOX)[..., None]
        water = torch.where(night[:, 0], night_w, day_w)[:, None, None]
        rgb = torch.where((dousing_count > 0)[..., None],
                          rgb * (1 - strength) + water * strength, rgb)
        return torch.where(at_pos, 0.0, rgb).to(self._obs_dtype)

    def _display_grid(self, extended_grid):
        """First ACTIVE extension channel, else the base channel, per env."""
        base = extended_grid[..., 0]
        extensions = extended_grid[..., 3:]
        k = extensions.shape[-1]
        if k == 0:
            return base
        has_ext = (extensions > 0).any(dim=-2).any(dim=-2)  # (N, k)
        first_valid = has_ext.to(torch.int32).argmax(dim=-1)
        any_ext = has_ext.any(dim=-1)
        out = base
        for c in range(k):
            pick = (any_ext & (first_valid == c))[:, None, None]
            out = torch.where(pick, extensions[..., c], out)
        return out

    def build_observation_on_extensions(self, grid, position, full_action, per_env,
                                        shared=None):
        """Channel stack (N, H, W, 3 + total_ext) and RGB of a batch."""
        is_night = per_env["is_night"]
        if self.enable_extensions and len(EXTENSION_REGISTRY) > 0:
            transformed = transform_grid(grid, is_night, 0, 0)
        else:
            transformed = grid
        zeros = torch.zeros(grid.shape, dtype=TYPE_BOX, device=grid.device)
        ext_channels = apply_extensions(grid, full_action[:, 2:], is_night,
                                        self.enable_extensions)
        extended = torch.stack([transformed.to(TYPE_BOX), zeros, zeros]
                               + [c.to(TYPE_BOX) for c in ext_channels], dim=-1)
        rgb = self._grid_to_rgb(self._display_grid(extended), is_night,
                                per_env["dousing_count"], position)
        return rgb, extended

    @span("observe")
    def _observe(self, grid, position, full_action, per_env):
        """The RGB of :meth:`build_observation_on_extensions`.  With
        extensions off every extension channel is zero and the display is the
        grid itself, so no channel stack is built."""
        if self.enable_extensions:
            return self.build_observation_on_extensions(grid, position, full_action,
                                                        per_env)[0]
        return self._grid_to_rgb(grid, per_env["is_night"], per_env["dousing_count"],
                                 position)

    def grid_to_rgb_with_extensions(self, extended_grid, per_env, position):
        return self._grid_to_rgb(self._display_grid(extended_grid), per_env["is_night"],
                                 per_env["dousing_count"], position)

    # ----------------------------------------------------------------- MDP

    def _time_frac(self, full_actions, time):
        time_taken = (self._move_timings[full_actions[:, 0].long()]
                      + self._shoot_timings[full_actions[:, 1].long()]
                      + self._t_env_any)
        return modf(time + time_taken)

    def _mdp_single(self, true_grid, full_action, per_env, shared, position, time):
        """The XLA-path counterpart: ``AlexandridisCA`` over the batch, with
        every draw from the JAX package's key chain."""
        pair = rng.split(per_env["key"])
        key, k_ca = pair[:, 0], pair[:, 1]
        frac, repeats = self._time_frac(full_action, time)
        ca_in = dict(per_env)
        ca_in["key"] = key
        if self.ca_repeat_mode == "single":
            grid, (next_per_env, _) = self.ca(true_grid, full_action, (ca_in, shared), k_ca)
        else:
            repeats_i = repeats.to(TYPE_INT)
            ca_keys = rng.split(k_ca, self._max_repeats)
            grid, ctx = true_grid, ca_in
            for i in range(self._max_repeats):
                new_grid, (new_ctx, _) = self.ca(grid, full_action, (ctx, shared),
                                                 ca_keys[:, i])
                pred = i < repeats_i
                grid = torch.where(_rows(pred, grid), new_grid, grid)
                ctx = {k: v if new_ctx[k] is v else torch.where(_rows(pred, v),
                                                                new_ctx[k], v)
                       for k, v in ctx.items()}
            next_per_env = ctx
        return self._post_ca(grid, next_per_env, full_action, per_env, shared, position,
                             frac)

    def _mdp_batch_fused(self, true_grid, full_actions, per_env, shared, position, time):
        """The batched MDP with the fused CA kernel: the key chain of the JAX
        package's ``_mdp_batch_pallas``, then one kernel launch."""
        pair = rng.split(per_env["key"])
        keys, k_ca = pair[:, 0], pair[:, 1].contiguous()  # k_ca seeds the kernel
        k_wchange = rng.fold_in(k_ca, 1)
        k_widx = rng.fold_in(k_ca, 2)
        frac, _ = self._time_frac(full_actions, time)

        wm = shared["winds"][per_env["wind_index"].long()]  # (N, 3, 3)
        wind_rows = torch.stack([wm[:, 1 + dr, 1 + dc] for dr, dc in NEIGHBOR_OFFSETS],
                                dim=-1)
        ca = self.ca
        new_grid, new_age = alexandridis_fused_step(
            true_grid, per_env["fire_age"], per_env["dousing_count"],
            per_env["veg_den_factor"], per_env["exp_slope"], wind_rows, k_ca,
            empty=self._empty, tree=self._tree, fire=self._fire,
            layer_coeffs=self._layer_coeffs,
            dousing_border=float(ca._dousing_border),
            dousing_inner=float(ca._dousing_inner),
            fire_age_min=int(ca.fire_age_min), fire_age_max=int(ca.fire_age_max),
        )

        n_winds = shared["winds"].shape[0]
        wind_change = rng.uniform(k_wchange) < shared["p_wind_change"]
        wind_index = per_env["wind_index"]
        new_wind_index = torch.where(
            wind_change, (wind_index + rng.randint(k_widx, (), 1, 8)) % n_winds,
            wind_index).to(wind_index.dtype)

        next_per_env = dict(per_env)
        next_per_env["key"] = keys
        next_per_env["fire_age"] = new_age.to(per_env["fire_age"].dtype)
        next_per_env["wind_index"] = new_wind_index
        return self._post_ca(new_grid.to(true_grid.dtype), next_per_env, full_actions,
                             per_env, shared, position, frac)

    def _post_ca(self, grid, next_per_env, full_action, per_env, shared, position, frac):
        """Everything after the CA: move, dousing write, day/night, obs.
        Shared by both CA paths (the JAX package's ``_post_ca_single``,
        batched)."""
        position = self.move.update(grid, full_action[:, 0], position)[1]
        _, (_, next_per_env["dousing_count"]) = self.modify_dousing.update(
            grid, full_action[:, 1], (position, next_per_env["dousing_count"]))
        next_per_env["true_grid"] = grid
        next_per_env["time_step"] = next_per_env["time_step"] + 1
        # Quirk of the reference, kept: the observation is rendered with the
        # PRE-step context (is_night and dousing lag one step).
        rgb = self._observe(grid, position, full_action, per_env)
        flip = next_per_env["time_step"] % shared["day_length"] == 0
        next_per_env["is_night"] = torch.where(flip, 1 - next_per_env["is_night"],
                                               next_per_env["is_night"])
        return rgb, grid, next_per_env, position, frac.to(TYPE_BOX)

    # --------------------------------------------------------------- public API

    @span("stateless_step")
    def stateless_step(self, action, obs, info):
        """One step of every env: ``(obs, reward, terminated, truncated,
        info)``; ``action`` is (N, 2 + n_registries) int."""
        _, context = obs
        per_env = context["per_env_context"]
        shared = context["shared_context"]
        full_actions = self._create_full_actions(action)
        mdp = self._mdp_batch_fused if self.use_fused_ca else self._mdp_single
        rgb, next_grid, next_per_env, next_pos, next_time = mdp(
            per_env["true_grid"], full_actions, per_env, shared, context["position"],
            context["time"])

        context = dict(context)
        context["per_env_context"] = next_per_env
        context["position"] = next_pos
        context["time"] = next_time

        next_done = self._is_done(next_grid)
        reward = self._award(next_grid)
        truncated = torch.zeros_like(next_done)
        info = dict(info)
        info["reward"] = reward
        info["terminated"] = next_done
        info["TimeLimit.truncated"] = truncated
        info["steps_elapsed"] = info["steps_elapsed"] + 1
        info["reward_accumulated"] = info["reward_accumulated"] + reward
        return (rgb, context), reward, next_done, truncated, info

    @span("conditional_reset")
    def conditional_reset(self, step_tuple, action):
        """Auto-reset terminated envs with fresh initial states drawn from
        the threaded per-env keys.  The merge always runs (no host test of
        ``terminated.any()``); with nothing terminated it leaves every leaf
        as it was."""
        obs, reward, terminated, truncated, info = step_tuple
        rgb, context = obs
        context = dict(context)
        per_env = dict(context["per_env_context"])
        shared = context["shared_context"]

        reset_keys = rng.fold_in(per_env["key"], 7)
        f_grids, f_ages, f_positions = self._initial_per_env_state(reset_keys)
        f_keys = rng.fold_in(reset_keys, 8)

        def merge(fresh, cur):
            return torch.where(_rows(terminated, cur), fresh, cur)

        merged_grid = merge(f_grids, per_env["true_grid"])
        context["position"] = merge(f_positions, context["position"])
        context["time"] = merge(torch.zeros_like(context["time"]), context["time"])
        per_env["fire_age"] = merge(f_ages, per_env["fire_age"])
        per_env["key"] = merge(f_keys, per_env["key"])
        per_env["dousing_count"] = merge(torch.zeros_like(per_env["dousing_count"]),
                                         per_env["dousing_count"])
        if self.use_hidden:
            fresh_wind = rng.randint(reset_keys, (), 0, 8)
        else:
            fresh_wind = torch.zeros_like(per_env["wind_index"])
        per_env["wind_index"] = merge(fresh_wind, per_env["wind_index"])
        # Quirk of the reference, kept: time_step and is_night persist
        # across episodes.
        per_env["true_grid"] = merged_grid

        full_actions = self._create_full_actions(action)
        fresh_rgb = self._observe(merged_grid, context["position"], full_actions, per_env)
        next_rgb = merge(fresh_rgb, rgb)

        context["per_env_context"] = per_env
        info = dict(info)
        info["steps_elapsed"] = torch.where(terminated, 0.0, info["steps_elapsed"])
        info["reward_accumulated"] = torch.where(terminated, 0.0,
                                                 info["reward_accumulated"])
        new_reward = self._award(merged_grid)
        return ((next_rgb, context), new_reward, torch.zeros_like(terminated), truncated,
                info)

    # ----------------------------------------------------------- reward / done

    def _award(self, grid):
        """-(f / (t + f + 1e-8)) per env."""
        t = (grid == self._tree).sum(dim=(-2, -1)).to(TYPE_BOX)
        f = (grid == self._fire).sum(dim=(-2, -1)).to(TYPE_BOX)
        return -(f / (t + f + 1e-8))

    def _is_done(self, grid):
        return ~(grid == self._fire).any(dim=-1).any(dim=-1)

    def count_cells(self, grid):
        return {v: (grid == v).sum(dim=(-2, -1))
                for v in (self._empty, self._tree, self._fire)}

    # ---------------------------------------------------------------- rendering

    def render(self, obs, info=None, env_idx: int = 0):
        """Render one env of the batch.  The env is stateless, so the caller
        passes the (rgb, context) obs returned by ``reset()`` /
        ``stateless_step()``; returns a matplotlib Figure."""
        from gymca_torch.utils.render import render_advanced

        return render_advanced(self, obs, info, env_idx)

    def _attribute_render(self, key: str, name: str):
        from gymca_torch.utils.render import plot_grid_attribute

        grids = self._terrain_ctx[key].cpu().numpy()
        return [plot_grid_attribute(grids[i], name) for i in range(self.num_envs)]

    def altitude_render(self):
        return self._attribute_render("altitude", "Altitude")

    def density_render(self):
        return self._attribute_render("density", "Density")

    def vegitation_render(self):  # (sic) the reference's spelling
        return self._attribute_render("vegetation", "Vegitation")
