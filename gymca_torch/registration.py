"""Environment registration and the public catalog.

Counterpart of ``gymca_tpu/registration.py``: ``REGISTERED_CA_ENVS`` (the
``gym.make`` ids), ``GYM_MAKE`` (the same ids in gymnasium's ``module:id``
form), ``get_prototypes()`` (the env classes) and ``_register_caenvs()``.

The ids live in gymnasium's namespace ``gymca_torch/``, apart from the JAX
package's bare ids: gymnasium's ``register`` overwrites an id it already
holds (a warning, no error), so with shared ids whichever package was
imported second would take over the other's ``gym.make``.  The envs run on
the card unless ``gym.make(id, device="cpu")`` names the CPU.
"""

from __future__ import annotations

LIBRARY = "gymca_torch"
NAMESPACE = "gymca_torch"

HELR, HELC = 42, 42
BULR, BULC = 256, 256

REGISTERED_CA_ENVS = {
    f"{NAMESPACE}/ForestFireHelicopter{HELR}x{HELC}-v1": {
        "kwargs": {"nrows": HELR, "ncols": HELC},
        "entry_point": "gymca_torch.gym_env:ForestFireHelicopterEnv",
    },
    f"{NAMESPACE}/ForestFireBulldozer{BULR}x{BULC}-v3": {
        "kwargs": {"nrows": BULR, "ncols": BULC},
        "entry_point": "gymca_torch.gym_env:ForestFireBulldozerEnv",
    },
}

GYM_MAKE = tuple(LIBRARY + ":" + ca_env for ca_env in REGISTERED_CA_ENVS)


def get_prototypes():
    """The three env classes; imports gymnasium."""
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv
    from gymca_torch.gym_env import ForestFireBulldozerEnv, ForestFireHelicopterEnv

    return (
        ForestFireHelicopterEnv,
        ForestFireBulldozerEnv,
        AdvancedForestFireBulldozerEnv,
    )


def _register_caenvs():
    """Register every id with gymnasium, once (a second call does nothing)."""
    from gymnasium.envs.registration import register, registry

    for ca_env, cfg in REGISTERED_CA_ENVS.items():
        if ca_env not in registry:
            register(ca_env, kwargs=cfg["kwargs"], entry_point=cfg["entry_point"])
