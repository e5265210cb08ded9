"""Plain reference of the Advanced ForestFireBulldozer: reset, step, auto-reset.

The semantics of gym-cellular-automata's Advanced env as the configuration
states them (hidden terrain, extensions off, one CA update a step, uint8
observation), in plain torch with no kernel:

* reset: each env's grid drawn with p_tree / p_empty, two fire cells at
  (3h/4, w/4 - 1..w/4) of age 2 * 1.5 h, the bulldozer at (0.15 h, 0.85 w),
  a wind direction of 8;
* step: the Alexandridis CA (a tree ignites where its uniform draw lies
  below ``1 - prod_d max(1 - p_d fire_d, 0)``, ``p_d = base * wind_d *
  exp_slope_d``, ``base = (heat - dousing) * veg_den_factor``, heat the
  ring-weighted fire around the cell, dousing the two-level 5x5 box of
  doused cells; new fires take an age in [1.5 s, 1.75 s) of the spread time
  s = 1.5 h, fires age by one and burn out at age <= 1), the wind turning
  with probability 0.06, then the move (clamped) and a shot marking the
  cell doused; day and night swap every 400 steps; the RGB observation
  rendered from the new grid and position with the pre-step night flag and
  dousing; reward ``-(f / (t + f + 1e-8))``; an env with no fire terminates;
* auto-reset: a terminated env restarts from fresh state drawn from its key
  (time step and night flag carry over).  The check also resets the end
  state with the envs of :func:`forced` marked terminated.

Every draw is the threefry chain of :mod:`benchmark.reference.keys`,
including the CA's two words a cell (a threefry2x32 hash of the flat cell
index under the step's CA key: a uniform ``(b1 >> 8) 2**-24`` and the age
``b2``).  ``low=True`` computes the float32 parts (the ignition threshold,
the time and the reward) in bfloat16: the control a comparison must fail.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import keys as K

OFFSETS = tuple((dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1) if (dr, dc) != (0, 0))
DAY = ((221, 209, 211), (169, 196, 153), (230, 129, 129))
NIGHT = ((105, 105, 105), (47, 79, 79), (139, 0, 0))
WATER_DAY, WATER_NIGHT = (0, 0, 200), (255, 165, 0)
WIND_THETAS = np.array([
    [[45, 0, 45], [90, 0, 90], [135, 180, 135]],
    [[90, 45, 0], [135, 0, 45], [180, 135, 90]],
    [[135, 90, 45], [180, 0, 0], [135, 90, 45]],
    [[180, 135, 90], [135, 0, 45], [90, 45, 0]],
    [[135, 180, 135], [90, 0, 90], [45, 0, 45]],
    [[90, 135, 180], [45, 0, 135], [0, 45, 90]],
    [[45, 90, 135], [0, 0, 180], [45, 90, 135]],
    [[0, 45, 90], [45, 0, 135], [90, 135, 180]],
], dtype=np.float64)


def _winds(device):
    """The 8 directional 3x3 wind factors ``exp(c1 V) exp(V c2 (cos t - 1))``,
    V = 10, c1 = 0.045, c2 = 0.131, centre 0, float32."""
    t = np.radians(WIND_THETAS)
    w = np.exp(0.045 * 10) * np.exp(10 * 0.131 * (np.cos(t) - 1))
    w[:, 1, 1] = 0.0
    return torch.tensor(w.astype(np.float32), device=device)


def _layer_coeffs(radius: int):
    """Box-sum coefficients of the heat kernel: total weight 0.065, each ring
    60% of what is left over its cells (ring 1 with the centre), the last
    ring the rest; ``c_j = w_{j-1} - w_j``, ``c_R = w_{R-1}``."""
    weights, remaining = [], 0.065
    for i in range(radius):
        cells = (2 * i + 3) ** 2 - (2 * i + 1) ** 2 + (1 if i == 0 else 0)
        if i == radius - 1:
            weights.append(remaining / cells)
        else:
            weights.append(remaining * 0.60 / cells)
            remaining *= 0.40
    return [weights[j - 1] - weights[j] for j in range(1, radius)] + [weights[-1]]


class Params:
    """The configuration's constants, as the env derives them."""

    def __init__(self, cfg: dict, device):
        dev = torch.device(device)
        self.h, self.w = h, w = cfg["nrows"], cfg["ncols"]
        self.empty, self.tree, self.fire = (cfg["cells"][k] for k in ("empty", "tree", "fire"))
        self.probs = (cfg["p_empty"], cfg["p_tree"], 0.0)
        scale = (h + w) // 2
        mult = cfg["speed_multiplier"]
        self.t_any = cfg["t_any"]
        t_move = 1 / (cfg["speed_move"] * mult * scale) - self.t_any
        t_shoot = 1 / (cfg["speed_act"] * mult * scale) - t_move
        self.move_t = torch.full((9,), t_move, dtype=torch.float32, device=dev)
        self.shoot_t = torch.full((2,), t_shoot, dtype=torch.float32, device=dev)
        self.winds = _winds(dev)
        self.p_wind_change = torch.tensor(cfg["p_wind_change"], dtype=torch.float32, device=dev)
        self.day_length = cfg["day_length"]
        spread = h + h // 2
        self.age_min, self.age_max = int(spread * 1.5), int(spread * 1.75)
        self.coeffs = _layer_coeffs(max(math.ceil(math.log2(max(h, 4))) - 2, 1))
        self.border = 0.0007 * self.age_max * 0.50
        self.inner = 0.006 * self.age_max * 0.50
        self.fire_rc = (3 * h // 4, w // 4)
        self.fire_age0 = (h + h // 2) * 2
        self.start = torch.tensor((int(h * 0.15), int(w * 0.85)), dtype=torch.int32, device=dev)
        self.drow = torch.tensor([-1, -1, -1, 0, 0, 0, 1, 1, 1], device=dev)
        self.dcol = torch.tensor([-1, 0, 1, -1, 0, 1, -1, 0, 1], device=dev)
        self.day = torch.tensor(DAY, dtype=torch.int32, device=dev)
        self.night = torch.tensor(NIGHT, dtype=torch.int32, device=dev)
        self.water_day = torch.tensor(WATER_DAY, dtype=torch.int32, device=dev)
        self.water_night = torch.tensor(WATER_NIGHT, dtype=torch.int32, device=dev)


def fresh(p: Params, keys):
    """Fresh (grid int8, fire age float32, position int32) of one env per key."""
    n, dev = keys.shape[0], keys.device
    values = torch.tensor((p.empty, p.tree, p.fire), dtype=torch.int8, device=dev)
    grid = values[K.choice(K.split(keys)[:, 0], (p.h, p.w), p.probs)]
    fr, fc = p.fire_rc
    age = torch.zeros(grid.shape, dtype=torch.float32, device=dev)
    for c in (fc, fc - 1):
        grid[:, fr, c] = p.fire
        age[:, fr, c] = p.fire_age0
    return grid, age, p.start.expand(n, 2).clone()


def render(p: Params, grid, is_night, dousing, position):
    """uint8 RGB: the day or night palette, the doused cells blended 1:3 with
    the water tint (rounded half to even), the bulldozer's cell black."""
    n = grid.shape[0]
    idx = torch.clamp(grid.to(torch.int32), 0, 2).long()
    night = is_night > 0
    palette = torch.where(night[:, None, None], p.night, p.day)
    water = torch.where(night[:, None], p.water_night, p.water_day)
    rgb = palette[torch.arange(n, device=grid.device)[:, None, None], idx]
    v = rgb + 3 * water[:, None, None]
    q, r = v >> 2, v & 3
    blended = q + (r == 3).int() + ((r == 2) & ((q & 1) == 1)).int()
    rgb = torch.where((dousing == 1)[..., None], blended, rgb)
    rows = torch.arange(p.h, device=grid.device)[None, :, None]
    cols = torch.arange(p.w, device=grid.device)[None, None, :]
    at = (rows == position[:, 0, None, None]) & (cols == position[:, 1, None, None])
    return torch.where(at[..., None], 0, rgb).to(torch.uint8)


def initial(p: Params, seed: int, n: int, terrain: dict, device) -> dict:
    """The reset of ``n`` envs from the env key ``key(seed)``."""
    pair = K.split(K.key(seed, device))
    env_keys = K.split(pair[1], n)
    grid, age, position = fresh(p, env_keys)
    zeros = torch.zeros(n, dtype=torch.float32, device=device)
    s = {
        "wind_index": K.randint(pair[0], (n,), 0, 8),
        "fire_age": age,
        "key": K.fold_in(env_keys, 1),
        "is_night": torch.zeros(n, dtype=torch.int32, device=device),
        "true_grid": grid,
        "time_step": torch.ones(n, dtype=torch.int32, device=device),
        "dousing_count": torch.zeros(grid.shape, dtype=torch.int8, device=device),
        "position": position,
        "time": zeros.clone(),
        "reward": zeros.clone(),
        "terminated": torch.zeros(n, dtype=torch.bool, device=device),
        "steps_elapsed": zeros.clone(),
        "reward_accumulated": zeros.clone(),
        "vdf": terrain["veg_den_factor"],
        "exp_slope": terrain["exp_slope"],
    }
    s["rgb"] = render(p, grid, s["is_night"], s["dousing_count"], position)
    return s


def box_sums(x, radii):
    """Chebyshev box sums with a zero boundary, exact through an int64
    summed-area table."""
    h, w = x.shape[-2:]
    sat = F.pad(torch.cumsum(torch.cumsum(x.to(torch.int64), -2), -1), (1, 0, 1, 0))
    rows = torch.arange(h, device=x.device)
    cols = torch.arange(w, device=x.device)

    def at(r, c):
        return sat[..., r[:, None], c[None, :]]

    out = {}
    for r in radii:
        lo_r, hi_r = (rows - r).clamp(0, h), (rows + r + 1).clamp(0, h)
        lo_c, hi_c = (cols - r).clamp(0, w), (cols + r + 1).clamp(0, w)
        out[r] = (at(hi_r, hi_c) - at(lo_r, hi_c) - at(hi_r, lo_c) + at(lo_r, lo_c)).to(x.dtype)
    return out


def ca(p: Params, grid, age, dousing, vdf, exp_slope, wind_rows, seeds, low=False):
    """One Alexandridis update of every env: (new grid int8, new age)."""
    h, w = grid.shape[-2:]
    ft = torch.bfloat16 if low else torch.float32
    idx = torch.arange(h * w, dtype=torch.int64, device=grid.device).reshape(h, w)
    b1, b2 = K.threefry2x32(seeds[:, 0, None, None], seeds[:, 1, None, None],
                            torch.zeros_like(idx), idx)
    u = (b1 >> 8).to(torch.float32) * 2.0 ** -24

    fire_f = (grid == p.fire).to(ft)
    radii = list(range(1, len(p.coeffs) + 1))
    boxes = box_sums(fire_f, radii)
    heat = torch.zeros_like(fire_f)
    for r, c in zip(radii, p.coeffs):
        heat = heat + c * boxes[r]
    dbox = box_sums((dousing > 0).to(ft), (1, 2))
    base = (heat - ((p.inner - p.border) * dbox[1] + p.border * dbox[2])) * vdf.to(ft)
    padded = F.pad(fire_f, (1, 1, 1, 1))
    no_ignite = torch.ones_like(base)
    for d, (dr, dc) in enumerate(OFFSETS):
        there = padded[..., 1 + dr:1 + dr + h, 1 + dc:1 + dc + w]
        pd = base * wind_rows[:, d, None, None].to(ft) * exp_slope[:, 1 + dr, 1 + dc].to(ft)
        no_ignite = no_ignite * torch.clamp(1.0 - pd * there, min=0.0)
    ignite = u < (1.0 - no_ignite).float()

    span = max(p.age_max - p.age_min, 1)
    sampled = (p.age_min + b2 % span).to(torch.float32)
    burning = grid == p.fire
    new = torch.where((grid == p.tree) & ignite, p.fire,
                      torch.where(burning & (age <= 1.0), p.empty, grid.to(torch.int32)))
    new_age = torch.where((new == p.fire) & ~burning, sampled, age)
    new_age = torch.where(burning, new_age - 1.0, new_age)
    return new.to(torch.int8), new_age


def step(p: Params, s: dict, actions, low: bool = False) -> dict:
    """``stateless_step`` then the auto-reset of every env; ``actions`` (N, 3)
    move in 0..8, shoot in 0..1, extension id 0."""
    ft = torch.bfloat16 if low else torch.float32
    n, dev = actions.shape[0], actions.device
    a_move, a_shoot = actions[:, 0].long(), actions[:, 1].long()
    pair = K.split(s["key"])
    key, k_ca = pair[:, 0], pair[:, 1]
    taken = (p.move_t[a_move].to(ft) + p.shoot_t[a_shoot].to(ft)) + p.t_any
    total = s["time"].to(ft) + taken
    frac = (total - torch.trunc(total)).to(torch.float32)

    wm = p.winds[s["wind_index"].long()]
    wind_rows = torch.stack([wm[:, 1 + dr, 1 + dc] for dr, dc in OFFSETS], -1)
    grid, age = ca(p, s["true_grid"], s["fire_age"], s["dousing_count"], s["vdf"],
                   s["exp_slope"], wind_rows, k_ca, low)
    change = K.uniform(K.fold_in(k_ca, 1)) < p.p_wind_change
    turned = (s["wind_index"] + K.randint(K.fold_in(k_ca, 2), (), 1, 8)) % 8
    wind_index = torch.where(change, turned, s["wind_index"]).to(torch.int32)

    env = torch.arange(n, device=dev)
    row = torch.clamp(s["position"][:, 0] + p.drow[a_move], 0, p.h - 1)
    col = torch.clamp(s["position"][:, 1] + p.dcol[a_move], 0, p.w - 1)
    position = torch.stack([row, col], -1).to(torch.int32)
    dousing = s["dousing_count"].clone()
    dousing[env, row, col] = torch.where(a_shoot == 1, 1, dousing[env, row, col]).to(torch.int8)
    time_step = s["time_step"] + 1
    rgb = render(p, grid, s["is_night"], s["dousing_count"], position)
    is_night = torch.where(time_step % p.day_length == 0, 1 - s["is_night"], s["is_night"])

    t = (grid == p.tree).sum((1, 2)).to(ft)
    f = (grid == p.fire).sum((1, 2)).to(ft)
    reward = (-(f / (t + f + 1e-8))).to(torch.float32)
    done = ~(grid == p.fire).any(-1).any(-1)
    out = dict(s, wind_index=wind_index, fire_age=age, key=key, is_night=is_night,
               true_grid=grid, time_step=time_step, dousing_count=dousing, position=position,
               time=frac, reward=reward, terminated=done,
               steps_elapsed=s["steps_elapsed"] + 1.0,
               reward_accumulated=s["reward_accumulated"] + reward, rgb=rgb)
    if bool(done.any()):
        out = _auto_reset(p, out, done)
    return out


def forced(n: int, device):
    """The envs the check marks terminated at the checked episode's end:
    every even one."""
    return torch.arange(n, device=device) % 2 == 0


def _auto_reset(p: Params, s: dict, done) -> dict:
    reset_keys = K.fold_in(s["key"], 7)
    f_grid, f_age, f_pos = fresh(p, reset_keys)

    def merge(new, cur):
        return torch.where(done.reshape((-1,) + (1,) * (cur.dim() - 1)), new, cur)

    out = dict(s)
    out["true_grid"] = merge(f_grid, s["true_grid"])
    out["position"] = merge(f_pos, s["position"])
    out["time"] = merge(torch.zeros_like(s["time"]), s["time"])
    out["fire_age"] = merge(f_age, s["fire_age"])
    out["key"] = merge(K.fold_in(reset_keys, 8), s["key"])
    out["dousing_count"] = merge(torch.zeros_like(s["dousing_count"]), s["dousing_count"])
    out["wind_index"] = merge(K.randint(reset_keys, (), 0, 8), s["wind_index"])
    fresh_rgb = render(p, out["true_grid"], s["is_night"], out["dousing_count"], out["position"])
    out["rgb"] = merge(fresh_rgb, s["rgb"])
    out["steps_elapsed"] = merge(torch.zeros_like(s["steps_elapsed"]), s["steps_elapsed"])
    out["reward_accumulated"] = merge(torch.zeros_like(s["reward_accumulated"]),
                                      s["reward_accumulated"])
    return out


# Every number is an exact comparison, so every limit is 0: the CA's draws
# are the same threefry words and its float32 arithmetic the same operations
# in the same order; the observation is integer arithmetic.
LIMITS = {"start_values_wrong": 0, "grid_cells_wrong": 0, "rgb_values_wrong": 0,
          "fire_ages_wrong": 0, "state_values_wrong": 0, "reward_gap": 0.0,
          "reset_values_wrong": 0}
_STATE = ("wind_index", "key", "is_night", "time_step", "dousing_count", "position", "time",
          "terminated", "steps_elapsed")
_ALL = _STATE + ("true_grid", "rgb", "fire_age", "reward", "reward_accumulated")


def check(start: dict, start_ref: dict, end: dict, end_ref: dict) -> dict:
    from benchmark.reference.compare import largest_gap, values_wrong

    return {
        "start_values_wrong": values_wrong(start, start_ref, _ALL),
        "grid_cells_wrong": values_wrong(end, end_ref, ("true_grid",)),
        "rgb_values_wrong": values_wrong(end, end_ref, ("rgb",)),
        "fire_ages_wrong": values_wrong(end, end_ref, ("fire_age",)),
        "state_values_wrong": values_wrong(end, end_ref, _STATE),
        "reward_gap": largest_gap(end, end_ref, ("reward", "reward_accumulated")),
        "reset_values_wrong": values_wrong(end, end_ref, tuple(f"reset.{k}" for k in _ALL)),
    }


def replay(cfg: dict, seed: int, envs: int, idx, actions, device, terrain: dict,
           low: bool = False):
    """The reference's reset and end states of envs ``idx`` of a batch of
    ``envs`` reset from ``seed`` on ``terrain``, stepped through ``actions``
    (T, N, 3), the end states with the reset of the :func:`forced` envs
    (``reset.<leaf>``).  The envs are stepped whole: the reset draws every
    env's keys from one chain."""
    p = Params(cfg, device)
    start = initial(p, seed, envs, {k: v.to(device) for k, v in terrain.items()}, device)
    s = start
    for a in actions:
        s = step(p, s, a.to(device), low)
    end = dict(s)
    end.update({f"reset.{k}": v for k, v in _auto_reset(p, s, forced(envs, device)).items()})
    pick = idx.to(device)
    return ({k: v[pick] for k, v in start.items()}, {k: v[pick] for k, v in end.items()})
