"""gymca_torch — the cellular-automata RL environments of ``gymca_tpu``, ported
to PyTorch and CUDA for an NVIDIA H100.  ``gymca_tpu`` is the reference; this
package imports none of it.

The public names follow ``gymca_tpu/__init__.py``.  gymnasium is an optional
dependency of the classic single-env surface: where it can be imported, the
envs are registered with ``gym.make`` on import (ids under the
``gymca_torch/`` namespace); ``GridSpace``, ``GymCAEnv`` and the ``gymca``
catalog load it on demand.  The cores, the Advanced env, the trainer and the
kernels need only torch.
"""

import importlib.util
from types import SimpleNamespace

from gymca_torch.core.env import CAEnvCore, EnvState, StepOutput, autoreset_step
from gymca_torch.core.operator import Identity, Operator
from gymca_torch.core.spaces import (
    BoxSpec,
    DictSpec,
    DiscreteSpec,
    GridSpec,
    MultiDiscreteSpec,
    TupleSpec,
)
from gymca_torch.registration import (
    GYM_MAKE,
    REGISTERED_CA_ENVS,
    _register_caenvs,
    get_prototypes,
)
from gymca_torch.version import VERSION as __version__

RELEASE = False

if importlib.util.find_spec("gymnasium") is not None:
    _register_caenvs()

__all__ = [
    "CAEnvCore",
    "EnvState",
    "StepOutput",
    "GymCAEnv",
    "autoreset_step",
    "Operator",
    "Identity",
    "GridSpace",
    "GridSpec",
    "BoxSpec",
    "DiscreteSpec",
    "MultiDiscreteSpec",
    "TupleSpec",
    "DictSpec",
    "gymca",
    "REGISTERED_CA_ENVS",
    "GYM_MAKE",
]


def __getattr__(name):
    # These import gymnasium: loaded only on demand.
    if name in ("GridSpace", "GymCAEnv"):
        from gymca_torch import gym_env

        return getattr(gym_env, name)
    if name == "gymca":
        # The public catalog, as the reference's ``gymca`` namespace.
        return SimpleNamespace(envs=GYM_MAKE, prototypes=get_prototypes())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
