"""The windy Bulldozer under test: ``gymca_torch``'s ``BulldozerCore``.

The window drives ``step_batched`` (kernel K1 on the card) over the batch,
restarting each episode from the reset states made in set-up.  The reset
states come from ``initial_state`` on keys the benchmark derives from the
seed, the same keys the reference resets from.
"""

from __future__ import annotations

import torch

from benchmark.reference import keys as K

# The answers' names, as the reference's states name them.
LEAVES = ("position", "pos_fire", "time", "hit", "tree_count", "fire_count")


def inputs(cfg: dict, envs: int, seed: int, device) -> dict:
    """The reset's keys derive from the seed alone: nothing more to hand."""
    return {}


class System:
    def __init__(self, cfg: dict, envs: int, seed: int, device):
        from gymca_torch.envs.bulldozer import BulldozerCore

        self.cfg = cfg
        self.core = BulldozerCore(
            cfg["nrows"], cfg["ncols"], speed_move=cfg["speed_move"],
            speed_act=cfg["speed_act"], t_any=cfg["t_any"], p_tree=cfg["p_tree"],
            p_empty=cfg["p_empty"], wind=cfg["wind"],
            grid_dtype=getattr(torch, cfg["grid_dtype"]), device=device)
        self.inputs = inputs(cfg, envs, seed, device)
        self.reset_states = self.core.initial_state(K.split(K.key(seed, device), envs))
        self.states = None

    def restart(self):
        self.states = self.reset_states.clone()  # step_batched writes grids in place

    def step(self, actions, span):
        with span("step_batched"):
            self.states, _ = self.core.step_batched(self.states, actions)

    def work_inputs(self) -> dict:
        """What K1's work count reads of the state a step starts from."""
        s = self.states
        return {"time": s.context["time"], "done": s.done,
                "edit_count": s.context["edit_count"]}

    def _answers(self, s, idx, grid) -> dict:
        out = {k: s.context[k][idx] for k in LEAVES}
        out.update(grid=grid, key=s.key[idx], done=s.done[idx],
                   steps_elapsed=s.steps_elapsed[idx],
                   reward_accumulated=s.reward_accumulated[idx])
        return out

    def start(self, idx) -> dict:
        """The set-up's reset states of envs ``idx``."""
        return self._answers(self.reset_states, idx, self.reset_states.grid[idx])

    def state(self):
        """The current states; the next episode's restart steps a clone."""
        return self.states

    def answers(self, idx, s, actions) -> dict:
        """States ``s`` of envs ``idx`` at the end of an episode stepped
        through ``actions``, the deferred edits written into the grids."""
        sub = s.replace(grid=s.grid[idx], key=s.key[idx], done=s.done[idx],
                        context={k: v[idx] for k, v in s.context.items()})
        return self._answers(s, idx, self.core.materialize_grid(sub))
