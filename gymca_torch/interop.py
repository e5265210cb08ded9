"""State and weights carried between the JAX package and the port, as numpy
arrays.

The JAX side hands over its leaves as numpy arrays (keys as
``jax.random.key_data(...)``, uint32):

* the windy Bulldozer's ``EnvState``: :func:`env_state_from_numpy` builds the
  port's state from them on a given device, :func:`env_state_to_numpy` gives
  them back in the JAX package's dtypes;
* the Advanced env's ``(rgb, context)`` observation and ``info``:
  :func:`advanced_obs_from_numpy` and :func:`advanced_obs_to_numpy`.
  bfloat16 leaves (``exp_slope``, ``veg_den_factor``) travel bit for bit as
  their 16-bit words: numpy holds JAX's as ``ml_dtypes.bfloat16``, which
  torch does not take, so they go through a ``uint16`` view, and come back
  as ``uint16`` words (``.view(jnp.bfloat16)`` on the JAX side);
* the PPO trainer's params, ``{"network_params", "actor_params",
  "critic_params"}``, each a flax tree ``{"params": {...}}``:
  :func:`ppo_params_from_numpy` and :func:`ppo_params_to_numpy`.  Conv
  kernels go HWIO -> OIHW and Dense kernels (in, out) -> (out, in); the
  torso flattens in NHWC order as flax does, so no row is permuted;
* the params blob, the pickle that ``scripts/train_curve.py --save-params``
  writes and ``scripts/eval_policy.py`` reads (params plus the run's
  config): :func:`load_params_blob` reads one, written by either package,
  without flax; :func:`save_params_blob` writes one that the JAX script
  loads.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from gymca_torch.config import resolve_device
from gymca_torch.core.env import EnvState

__all__ = ["env_state_from_numpy", "env_state_to_numpy", "advanced_obs_from_numpy",
           "advanced_obs_to_numpy", "ppo_params_from_numpy", "ppo_params_to_numpy",
           "load_params_blob", "save_params_blob", "BLOB_CONFIG_KEYS"]

_BF16_KEYS = ("exp_slope", "veg_den_factor")


def _to_torch(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x), device=device)  # a copy


def env_state_from_numpy(*, grid, context: Dict[str, np.ndarray], key, done,
                         steps_elapsed, reward_accumulated, device=None) -> EnvState:
    """The port's ``EnvState`` from the JAX state's leaves: ``grid`` (N, H, W),
    every ``context`` entry (``edit_log`` and ``edit_count`` included),
    ``key`` as (N, 2) uint32 key data, ``done``, ``steps_elapsed`` and
    ``reward_accumulated`` (N,)."""
    dev = resolve_device(device)
    return EnvState(
        grid=_to_torch(grid, dev),
        context={k: _to_torch(v, dev) for k, v in context.items()},
        key=_to_torch(_key_from_numpy(key), dev),
        done=_to_torch(done, dev),
        steps_elapsed=_to_torch(steps_elapsed, dev),
        reward_accumulated=_to_torch(reward_accumulated, dev),
    )


def env_state_to_numpy(state: EnvState) -> Dict[str, object]:
    """The leaves of ``state`` as numpy arrays, keyed as
    :func:`env_state_from_numpy` takes them; the key as uint32 key data."""

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    return {
        "grid": host(state.grid),
        "context": {k: host(v) for k, v in state.context.items()},
        "key": host(state.key).astype(np.uint32),
        "done": host(state.done),
        "steps_elapsed": host(state.steps_elapsed),
        "reward_accumulated": host(state.reward_accumulated),
    }


def _bf16_from_numpy(x, device) -> torch.Tensor:
    """A 2-byte float array (``ml_dtypes.bfloat16``, or its ``uint16``
    words) as a torch bfloat16 tensor with the same bits."""
    words = np.ascontiguousarray(np.asarray(x)).view(np.uint16).view(np.int16)
    return torch.tensor(words, device=device).view(torch.bfloat16)


def _key_from_numpy(key) -> np.ndarray:
    key = np.asarray(key)
    if key.dtype != np.uint32 or key.shape[-1:] != (2,):
        raise ValueError(f"key must be (..., 2) uint32 key data, got "
                         f"{key.dtype} {key.shape}")
    return key.astype(np.int64)


def advanced_obs_from_numpy(rgb, context: Dict[str, object], info: Dict[str, object],
                            *, device=None):
    """The port's Advanced ``((rgb, context), info)`` from the JAX env's
    leaves as numpy arrays: ``context`` holds ``per_env_context`` (with the
    per-env terrain and ``key`` as (N, 2) uint32 key data),
    ``shared_context``, ``position`` and ``time``."""
    dev = resolve_device(device)
    per_env = {}
    for k, v in context["per_env_context"].items():
        if k in _BF16_KEYS:
            per_env[k] = _bf16_from_numpy(v, dev)
        elif k == "key":
            per_env[k] = _to_torch(_key_from_numpy(v), dev)
        else:
            per_env[k] = _to_torch(v, dev)
    out = {
        "per_env_context": per_env,
        "shared_context": {k: _to_torch(v, dev)
                           for k, v in context["shared_context"].items()},
        "position": _to_torch(context["position"], dev),
        "time": _to_torch(context["time"], dev),
    }
    return (_to_torch(rgb, dev), out), {k: _to_torch(v, dev) for k, v in info.items()}


def advanced_obs_to_numpy(obs, info):
    """``(rgb, context, info)`` as numpy arrays, keyed as
    :func:`advanced_obs_from_numpy` takes them: keys as uint32 key data,
    bfloat16 leaves as their ``uint16`` words."""

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    rgb, context = obs
    per_env = {}
    for k, v in context["per_env_context"].items():
        if k in _BF16_KEYS:
            per_env[k] = host(v.view(torch.int16)).view(np.uint16)
        elif k == "key":
            per_env[k] = host(v).astype(np.uint32)
        else:
            per_env[k] = host(v)
    out = {
        "per_env_context": per_env,
        "shared_context": {k: host(v) for k, v in context["shared_context"].items()},
        "position": host(context["position"]),
        "time": host(context["time"]),
    }
    return host(rgb), out, {k: host(v) for k, v in info.items()}


_PPO_GROUPS = ("actor_params", "critic_params", "network_params")


def _flat_flax(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if hasattr(v, "items"):  # a dict or a flax FrozenDict
            yield from _flat_flax(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def ppo_params_from_numpy(tree, device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's params (``PPOTrainer``'s ``agent_state.params``) from the
    JAX trainer's: ``{group: {state-dict name: tensor}}`` in flax's leaf
    order, float32 on ``device`` (the card unless the caller names another)."""
    dev = resolve_device(device)
    out = {}
    for group in _PPO_GROUPS:
        leaves = {}
        for path, v in _flat_flax(tree[group]["params"]):
            a = np.asarray(v)
            if path[-1] == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            name = ".".join(path[:-1] + ("weight" if path[-1] == "kernel" else path[-1],))
            leaves[name] = torch.tensor(np.ascontiguousarray(a), device=dev)
        out[group] = leaves
    return out


def ppo_params_to_numpy(params) -> Dict[str, Dict[str, object]]:
    """The JAX trainer's params tree, as numpy arrays, from the port's:
    the inverse of :func:`ppo_params_from_numpy`, bit for bit."""
    out = {}
    for group in _PPO_GROUPS:
        tree: Dict[str, object] = {}
        for name, t in params[group].items():
            *mods, leaf = name.split(".")
            a = t.detach().cpu().numpy()
            if leaf == "weight":
                leaf = "kernel"
                a = np.ascontiguousarray(a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T)
            node = tree
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = a
        out[group] = {"params": tree}
    return out


# The run config a params blob carries beside ``params``
# (``scripts/train_curve.py:193-204``).
BLOB_CONFIG_KEYS = ("size", "num_envs", "seed", "ca_repeat_mode", "position_features",
                    "centroid_features", "bf16")

# What a blob may reference: numpy's array and dtype reconstructors, plain
# builtin containers and scalars, and flax's FrozenDict (read as a dict).
_NUMPY_MODULES = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.core.numeric", "numpy._core.numeric")
_NUMPY_NAMES = ("ndarray", "dtype", "_reconstruct", "scalar", "_frombuffer")
_BUILTIN_NAMES = ("dict", "list", "tuple", "set", "frozenset", "int", "float", "complex",
                  "bool", "str", "bytes", "bytearray", "slice", "range")


def _frozen_dict(mapping=()):
    """Stand-in for ``flax.core.frozen_dict.FrozenDict`` when unpickling: its
    ``__reduce__`` rebuilds it from a plain dict, which is what the port
    keeps."""
    return dict(mapping)


class _BlobUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("flax.core.frozen_dict", "FrozenDict"):
            return _frozen_dict
        if module in _NUMPY_MODULES and name in _NUMPY_NAMES:
            return super().find_class(module, name)
        if module == "numpy.dtypes" and name.endswith("DType"):
            return super().find_class(module, name)
        if module == "builtins" and name in _BUILTIN_NAMES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"a params blob may not reference {module}.{name}")


def load_params_blob(path, device=None) -> Dict[str, object]:
    """A params blob (written by ``scripts/train_curve.py --save-params`` or
    by :func:`save_params_blob`) as a dict: ``params``, the port's params
    (:func:`ppo_params_from_numpy`, on ``device``, the card unless the caller
    names another), and the run config of ``BLOB_CONFIG_KEYS``.  flax is not
    imported: its FrozenDict reads as a dict, and any class outside numpy's
    arrays and builtin containers is refused."""
    with open(path, "rb") as f:
        blob = _BlobUnpickler(f).load()
    return {**blob, "params": ppo_params_from_numpy(blob["params"], device)}


def save_params_blob(path, params, **config) -> Path:
    """Write the port's ``params`` as a params blob at ``path``: flax's
    layout in plain dicts of numpy arrays (:func:`ppo_params_to_numpy`) and
    exactly the run config of ``BLOB_CONFIG_KEYS``, which ``config`` must
    give.  ``scripts/eval_policy.py`` loads it as it loads its own."""
    if set(config) != set(BLOB_CONFIG_KEYS):
        raise ValueError(f"config must hold exactly {BLOB_CONFIG_KEYS}, got {sorted(config)}")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"params": ppo_params_to_numpy(params),
                     **{k: config[k] for k in BLOB_CONFIG_KEYS}}, f)
    return path
