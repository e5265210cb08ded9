"""The Operator algebra: an environment is a composition of grid transforms.

Counterpart of ``gymca_tpu/core/operator.py``.  Every Operator is

    ``update(grid, action, context, keys) -> (new_grid, new_context)``

over a batch of envs: ``grid`` is ``(N, H, W)``, every other argument carries
the same leading ``N`` (the JAX package writes one env and ``vmap``s it), and
``keys`` is ``(N, 2)`` key data from ``gymca_torch.rng``.  Deterministic
operators ignore the keys (they may be ``None``).  Operators return new
tensors and leave their inputs unchanged.
"""

from __future__ import annotations

from typing import Optional, Tuple

from gymca_torch import rng
from gymca_torch.core.spaces import Spec

__all__ = ["Operator", "Identity", "Sequence"]


class Operator:
    """Abstract batched grid transform."""

    suboperators: Tuple["Operator", ...] = tuple()

    grid_dependant: Optional[bool] = None
    action_dependant: Optional[bool] = None
    context_dependant: Optional[bool] = None

    deterministic: Optional[bool] = None

    def __init__(
        self,
        grid_spec: Optional[Spec] = None,
        action_spec: Optional[Spec] = None,
        context_spec: Optional[Spec] = None,
    ) -> None:
        self.grid_spec = grid_spec
        self.action_spec = action_spec
        self.context_spec = context_spec

    def update(self, grid, action, context, keys=None):
        """Returns ``(new_grid, new_context)``."""
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        return self.update(*args, **kwargs)

    def tree_flatten_ops(self):
        """Yield self and all suboperators, depth-first."""
        yield self
        for sub in self.suboperators:
            yield from sub.tree_flatten_ops()


class Identity(Operator):
    """Minimal no-op Operator."""

    grid_dependant = True
    action_dependant = False
    context_dependant = False
    deterministic = True

    def update(self, grid, action, context, keys=None):
        return grid, context


class Sequence(Operator):
    """Compose operators left-to-right over (grid, context) with split keys."""

    grid_dependant = True
    action_dependant = True
    context_dependant = True

    def __init__(self, operators: Tuple[Operator, ...], **kwargs):
        super().__init__(**kwargs)
        self.suboperators = tuple(operators)
        self.deterministic = all(op.deterministic for op in operators)

    def update(self, grid, action, context, keys=None):
        n_ops = len(self.suboperators)
        sub = rng.split(keys, n_ops) if keys is not None else None
        for i, op in enumerate(self.suboperators):
            grid, context = op(grid, action, context,
                               None if sub is None else sub[..., i, :])
        return grid, context
