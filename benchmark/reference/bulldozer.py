"""Plain reference of the windy ForestFireBulldozer: reset and step of a batch.

The semantics of gym-cellular-automata's ForestFireBulldozer as the
configuration states them, in plain torch with no kernel and no deferred
edits: cells empty/tree/fire; a reset grid drawn with p_tree / p_empty, one
fire seed near the lower-left quadrant and the bulldozer near the
upper-right, each placed with 1/12-axis noise; each step accumulates the
action's time, and when a whole CA period has passed applies one windy CA
update (one 3x3 gust roll per env: the neighbour at offset (dr, dc) spreads
fire where wind[1-dr, 1-dc] exceeds its roll), then moves the bulldozer
(clamped) and, on a shot, turns the tree under it empty; reward
``-(f / max(t + f, 1))``; an env with no fire is done and frozen.  Every
draw is the threefry chain of :mod:`benchmark.reference.keys`.

``low=True`` computes the float32 parts (the accumulated time, the gust
comparison and the reward) in bfloat16 instead: the control that a
comparison must fail.
"""

from __future__ import annotations

import torch

from benchmark.reference import keys as K

# The 8 Moore offsets in row-major order.
OFFSETS = tuple((dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1) if (dr, dc) != (0, 0))
IDENTITY, PROPAGATION = 2**11, 2**3


class Params:
    """The configuration's constants, as the env derives them."""

    def __init__(self, cfg: dict, device):
        self.h, self.w = cfg["nrows"], cfg["ncols"]
        self.empty, self.tree, self.fire = (cfg["cells"][k] for k in ("empty", "tree", "fire"))
        self.dtype = getattr(torch, cfg["grid_dtype"])
        self.probs = (cfg["p_empty"], cfg["p_tree"], 0.0)
        w = cfg["wind"]
        self.wind = torch.tensor([[w["up_left"], w["up"], w["up_right"]],
                                  [w["left"], 0.0, w["right"]],
                                  [w["down_left"], w["down"], w["down_right"]]],
                                 dtype=torch.float32, device=device)
        scale = (self.h + self.w) // 2
        t_any = cfg["t_any"]
        t_move = 1 / (cfg["speed_move"] * scale) - t_any
        t_shoot = 1 / (cfg["speed_act"] * scale) - t_move
        if t_move + t_shoot + t_any >= 1:
            raise ValueError("this reference applies at most one CA update a step")
        move = [t_move] * 9
        move[4] = 0.0  # not moving costs nothing
        self.move_t = torch.tensor(move, dtype=torch.float32, device=device)
        self.shoot_t = torch.tensor([0.0, t_shoot], dtype=torch.float32, device=device)
        self.t_any = torch.tensor(t_any, dtype=torch.float32, device=device)
        self.drow = torch.tensor([-1, -1, -1, 0, 0, 0, 1, 1, 1], device=device)
        self.dcol = torch.tensor([-1, 0, 1, -1, 0, 1, -1, 0, 1], device=device)


def env_keys(seed: int, n: int, device) -> torch.Tensor:
    """The (n, 2) keys the benchmark hands the env's reset."""
    return K.split(K.key(seed, device), n)


def initial(p: Params, keys: torch.Tensor, low: bool = False) -> dict:
    """Reset states of ``len(keys)`` envs."""
    n, dev = keys.shape[0], keys.device
    sub = K.split(keys, 6)
    values = torch.tensor((p.empty, p.tree, p.fire), dtype=p.dtype, device=dev)
    grid = values[K.choice(sub[:, 0], (p.h, p.w), p.probs)]

    def noise(k, length):
        upper = int(length * (1 / 12))
        return K.randint(k, (), 0, upper) if upper > 0 else torch.zeros(n, dtype=torch.int32,
                                                                         device=dev)

    fr = 3 * p.h // 4 + noise(sub[:, 1], p.h)
    fc = p.w // 4 + noise(sub[:, 2], p.w)
    env = torch.arange(n, device=dev)
    grid[env, fr.long(), fc.long()] = p.fire
    br = p.h // 4 + noise(sub[:, 3], p.h)
    bc = 3 * p.w // 4 + noise(sub[:, 4], p.w)
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    return {
        "grid": grid,
        "position": torch.stack([br, bc], -1).to(torch.int32),
        "pos_fire": torch.stack([fr, fc], -1).to(torch.int32),
        "time": torch.zeros(n, dtype=torch.bfloat16 if low else torch.float32, device=dev),
        "hit": torch.zeros(n, dtype=torch.bool, device=dev),
        "tree_count": (grid == p.tree).sum((1, 2)).to(torch.int32),
        "fire_count": (grid == p.fire).sum((1, 2)).to(torch.int32),
        "key": sub[:, 5],
        "done": torch.zeros(n, dtype=torch.bool, device=dev),
        "steps_elapsed": zeros,
        "reward_accumulated": torch.zeros(n, dtype=torch.float32, device=dev),
    }


def windy_update(p: Params, grid: torch.Tensor, success: torch.Tensor) -> torch.Tensor:
    """One windy CA update given each env's (3, 3) gust successes."""
    g = grid.to(torch.int32)
    padded = torch.nn.functional.pad(g, (1, 1, 1, 1), value=p.empty)
    signal = IDENTITY * g
    for dr, dc in OFFSETS:
        weight = torch.where(success[:, 1 - dr, 1 - dc], PROPAGATION, 0)[:, None, None]
        signal = signal + weight * padded[:, 1 + dr:1 + dr + p.h, 1 + dc:1 + dc + p.w]
    keep = IDENTITY * p.tree
    propagate = keep + PROPAGATION * p.fire
    consume = IDENTITY * p.fire
    out = torch.where(signal >= consume, p.empty,
                      torch.where(signal >= propagate, p.fire,
                                  torch.where(signal >= keep, p.tree, p.empty)))
    return out.to(grid.dtype)


def step(p: Params, s: dict, actions: torch.Tensor, low: bool = False) -> dict:
    """One step of every env: ``actions`` (N, 2) move in 0..8, shoot in 0..1."""
    ft = torch.bfloat16 if low else torch.float32
    n, dev = actions.shape[0], actions.device
    a_move, a_shoot = actions[:, 0].long(), actions[:, 1].long()
    pair = K.split(s["key"])
    k_ca = K.split(pair[:, 1])[:, 0]
    roll = K.uniform(K.split(k_ca, 1)[:, 0], (3, 3))

    taken = ((p.move_t[a_move].to(ft) + p.shoot_t[a_shoot].to(ft)) + p.t_any.to(ft))
    total = s["time"] + taken
    whole = torch.trunc(total)
    frac = total - whole
    do_ca = whole >= 1
    success = p.wind.to(ft) > roll.to(ft)
    grid = torch.where(do_ca[:, None, None], windy_update(p, s["grid"], success), s["grid"])

    env = torch.arange(n, device=dev)
    row = torch.clamp(s["position"][:, 0] + p.drow[a_move], 0, p.h - 1)
    col = torch.clamp(s["position"][:, 1] + p.dcol[a_move], 0, p.w - 1)
    cell = grid[env, row, col]
    hit = (a_shoot == 1) & (cell == p.tree)
    grid = grid.clone()
    grid[env, row, col] = torch.where(hit, p.empty, cell).to(grid.dtype)
    t = (grid == p.tree).sum((1, 2)).to(torch.int32)
    f = (grid == p.fire).sum((1, 2)).to(torch.int32)

    was = s["done"]

    def keep(new, old):
        return torch.where(was.reshape((n,) + (1,) * (new.dim() - 1)), old, new)

    position = torch.stack([row, col], -1).to(torch.int32)
    t, f = keep(t, s["tree_count"]), keep(f, s["fire_count"])
    tf, ff = t.to(ft), f.to(ft)
    reward = torch.where(was, torch.zeros((), dtype=ft, device=dev),
                         -(ff / torch.clamp(tf + ff, min=1.0))).to(torch.float32)
    return {
        "grid": keep(grid, s["grid"]),
        "position": keep(position, s["position"]),
        "pos_fire": s["pos_fire"],
        "time": keep(frac, s["time"]),
        "hit": keep(hit, s["hit"]),
        "tree_count": t,
        "fire_count": f,
        "key": pair[:, 0],
        "done": was | (f == 0),
        "steps_elapsed": s["steps_elapsed"] + (~was).to(torch.int32),
        "reward_accumulated": s["reward_accumulated"] + reward,
    }


# Every number is an exact comparison, so every limit is 0: the program's
# integer CA and its float32 time and reward arithmetic are the reference's
# operation for operation.
LIMITS = {"start_values_wrong": 0, "grid_cells_wrong": 0, "state_values_wrong": 0,
          "reward_gap": 0.0}
_STATE = ("position", "pos_fire", "time", "hit", "tree_count", "fire_count", "key", "done",
          "steps_elapsed")


def check(start: dict, start_ref: dict, end: dict, end_ref: dict) -> dict:
    """The compared numbers: the reset states, then the states after the
    episode's steps."""
    from benchmark.reference.compare import largest_gap, values_wrong

    return {
        "start_values_wrong": values_wrong(start, start_ref, ("grid",) + _STATE),
        "grid_cells_wrong": values_wrong(end, end_ref, ("grid",)),
        "state_values_wrong": values_wrong(end, end_ref, _STATE),
        "reward_gap": largest_gap(end, end_ref, ("reward_accumulated",)),
    }


def replay(cfg: dict, seed: int, envs: int, idx, actions, device, low: bool = False):
    """The reference's reset and end states of envs ``idx`` of a batch of
    ``envs`` reset from ``seed``, stepped through ``actions`` (T, N, 2)."""
    p = Params(cfg, device)
    keys = env_keys(seed, envs, device)[idx.to(device)]
    start = initial(p, keys, low)
    s = start
    for a in actions:
        s = step(p, s, a[idx.to(a.device)].to(device), low)
    return start, s
