"""The Advanced env under test: ``gymca_torch``'s
``AdvancedForestFireBulldozerEnv``.

The window drives ``stateless_step`` then ``conditional_reset`` (the fused
CA, kernel K2 on the card), restarting each episode from the set-up's
``reset()``.  The env key is ``key(seed)``; the hidden terrain is the
benchmark's (:mod:`benchmark.terrain`), handed to the env and the reference
alike.

Random actions put no fire out within an episode, so no env of the window
resets by itself.  The answers therefore also hold ``conditional_reset``
called once more on the checked episode's end state of the whole batch,
with the envs of :func:`benchmark.reference.advanced.forced` marked
terminated (``reset.<leaf>``): the fresh states the reset draws, and the
states it must keep, at the cell's size.
"""

from __future__ import annotations

import torch

from benchmark.reference import keys as K
from benchmark.reference.advanced import forced
from benchmark.terrain import make_terrain

PER_ENV = ("wind_index", "fire_age", "key", "is_night", "true_grid", "time_step",
           "dousing_count")
INFO = ("reward", "terminated", "steps_elapsed", "reward_accumulated")


def inputs(cfg: dict, envs: int, seed: int, device) -> dict:
    """What the benchmark hands the env and the reference: the terrain."""
    return {"terrain": make_terrain(envs, cfg["nrows"], cfg["ncols"], seed, device)}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    return tree.clone()


class System:
    def __init__(self, cfg: dict, envs: int, seed: int, device):
        from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv

        self.cfg = cfg
        h, w = cfg["nrows"], cfg["ncols"]
        self.inputs = inputs(cfg, envs, seed, device)  # handed to the reference too
        self.env = AdvancedForestFireBulldozerEnv(
            h, w, key=K.key(seed, device), num_envs=envs, speed_move=cfg["speed_move"],
            speed_act=cfg["speed_act"], speed_multiplier=cfg["speed_multiplier"],
            t_any=cfg["t_any"], p_tree=cfg["p_tree"], p_empty=cfg["p_empty"],
            use_hidden=cfg["use_hidden"], enable_extensions=cfg["enable_extensions"],
            ca_repeat_mode=cfg["ca_repeat_mode"], use_fused_ca=cfg["use_fused_ca"],
            obs_dtype=getattr(torch, cfg["obs_dtype"]), terrain=_clone(self.inputs["terrain"]),
            device=device)
        self.reset_obs, self.reset_info = self.env.reset()
        self.obs = self.info = None

    def restart(self):
        self.obs, self.info = _clone(self.reset_obs), _clone(self.reset_info)

    def step(self, actions, span):
        with span("stateless_step"):
            out = self.env.stateless_step(actions, self.obs, self.info)
        with span("conditional_reset"):
            back = self.env.conditional_reset(out, actions)
        self.obs, self.info = back[0], back[4]

    def work_inputs(self) -> dict:
        """What K2's work count reads of the state a step starts from."""
        return {"grid": self.obs[1]["per_env_context"]["true_grid"]}

    @staticmethod
    def _answers(obs, info, idx) -> dict:
        rgb, context = obs
        out = {k: context["per_env_context"][k][idx] for k in PER_ENV}
        out.update({k: info[k][idx] for k in INFO})
        out.update(rgb=rgb[idx], position=context["position"][idx], time=context["time"][idx])
        return out

    def start(self, idx) -> dict:
        return self._answers(self.reset_obs, self.reset_info, idx)

    def state(self):
        return self.obs, self.info

    def answers(self, idx, state, actions) -> dict:
        """Envs ``idx`` of ``state``, the end of an episode stepped through
        ``actions``, and of the reset of the envs :func:`forced` marks."""
        obs, info = state
        done = forced(obs[0].shape[0], obs[0].device)
        back = self.env.conditional_reset(
            (obs, info["reward"], done, torch.zeros_like(done), info), actions[-1])
        out = self._answers(obs, info, idx)
        out.update({f"reset.{k}": v for k, v in self._answers(back[0], back[4], idx).items()})
        return out
