"""Checkpoints of the FULL training state, with ``torch.save``.

Counterpart of ``gymca_tpu/agents/checkpoint.py`` (orbax there): a
checkpoint holds the agent state (params, optimizer state, update count),
the trainer's key data and an optional env carry, so training resumes where
it stopped.  One directory per step under ``directory``, the latest
``max_to_keep`` (2) kept.  A step is written to a temporary directory and
renamed into place, so a crash never leaves half a checkpoint as the latest.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional, Tuple

import torch

__all__ = ["CheckpointManager"]

_STATE_FILE = "state.pt"


class CheckpointManager:
    """``save_state``, ``latest_step``, ``restore_state`` and ``close``, as
    the JAX package's manager (max_to_keep=2, like the reference
    jax_ppo.py:435-443)."""

    def __init__(self, directory: str, max_to_keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(
                          os.path.join(self.directory, d, _STATE_FILE)))

    def save_state(self, step: int, agent_state, key, env_carry: Any = None):
        payload = {
            "params": agent_state.params,
            "opt_state": {"count": agent_state.opt_state.count,
                          "mu": agent_state.opt_state.mu,
                          "nu": agent_state.opt_state.nu,
                          "learning_rate": agent_state.opt_state.learning_rate},
            "train_step": agent_state.step,
            "key": key,
        }
        if env_carry is not None:
            payload["env_carry"] = env_carry
        final = os.path.join(self.directory, str(int(step)))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, _STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_state(self, agent_state, key, env_carry: Any = None) -> Tuple[Any, ...]:
        """Restore onto the templates' device; returns (agent_state, key)
        (+ the env carry if given a template)."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        restored = torch.load(os.path.join(self.directory, str(step), _STATE_FILE),
                              map_location=key.device, weights_only=True)
        opt = restored["opt_state"]
        new_state = agent_state.replace(
            params=restored["params"],
            opt_state=agent_state.opt_state.replace(
                count=opt["count"], mu=opt["mu"], nu=opt["nu"],
                learning_rate=opt["learning_rate"]),
            step=restored["train_step"],
        )
        if env_carry is not None:
            return new_state, restored["key"], restored["env_carry"]
        return new_state, restored["key"]

    def close(self):
        """Nothing stays open between calls; kept for the JAX API."""
