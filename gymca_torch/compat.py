"""The reference's public names (``gym_cellular_automata``) on the port.

Counterpart of ``gymca_tpu/compat.py``:

    import gymca_torch.compat as gym_cellular_automata

gives ``gymca`` (with ``.envs`` / ``.prototypes``), ``CAEnv``, ``GridSpace``,
``Operator``, ``RELEASE``, ``__version__`` and the operator and env classes
under their reference names.  Imports gymnasium.
"""

from __future__ import annotations

from types import SimpleNamespace

from gymca_torch import GYM_MAKE, REGISTERED_CA_ENVS, RELEASE, __version__
from gymca_torch.core.operator import Identity, Operator
from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv
from gymca_torch.gym_env import ForestFireBulldozerEnv, ForestFireHelicopterEnv, GridSpace
from gymca_torch.gym_env import GymCAEnv as CAEnv
from gymca_torch.ops.alexandridis import AlexandridisCA as PartiallyObservableForestFireJax
from gymca_torch.ops.drossel import ForestFire
from gymca_torch.ops.move_modify import Modify, Move, MoveModify
from gymca_torch.ops.repeat_ca import RepeatCA
from gymca_torch.ops.windy import WindyForestFire
from gymca_torch.registration import get_prototypes
gymca = SimpleNamespace(envs=GYM_MAKE, prototypes=get_prototypes())
envs = gymca.envs
prototypes = gymca.prototypes

__all__ = [
    "gymca",
    "envs",
    "prototypes",
    "CAEnv",
    "GridSpace",
    "Operator",
    "Identity",
    "RELEASE",
    "__version__",
    "GYM_MAKE",
    "REGISTERED_CA_ENVS",
    "ForestFire",
    "WindyForestFire",
    "PartiallyObservableForestFireJax",
    "Move",
    "Modify",
    "MoveModify",
    "RepeatCA",
    "ForestFireHelicopterEnv",
    "ForestFireBulldozerEnv",
    "AdvancedForestFireBulldozerEnv",
]
