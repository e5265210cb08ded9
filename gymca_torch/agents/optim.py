"""The PPO trainer's optimizer: optax's formulas on torch tensors.

Counterpart of ``optax.chain(clip_by_global_norm(max_grad_norm),
inject_hyperparams(adam)(learning_rate=schedule, eps=1e-5))``
(``gymca_tpu/agents/ppo.py:202-211``) and of the plain ``optax.adam(lr)`` of
``bc_pretrain``.  Params, grads and moments are ``{group: {name: tensor}}``
trees in one fixed order; everything runs on the params' device with no
host synchronisation (the learning rate and the clip trigger stay device
scalars).

* Clipping: ``where(norm < max_norm, g, (g / norm) * max_norm)`` with
  ``norm = sqrt(sum_leaves sum(g * g))`` (``optax.clip_by_global_norm``;
  ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and is not it).
* Adam: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
  ``update = -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)`` with
  ``t`` the count after the update (``optax.scale_by_adam``).
* The learning rate: a schedule of the count before the update, kept in the
  state as optax's ``inject_hyperparams`` keeps it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Union

import torch

__all__ = ["AdamState", "adam_init", "adam_update", "clip_by_global_norm", "linear_schedule",
           "tree_map", "tree_leaves", "tree_unflatten"]

Tree = Dict[str, Dict[str, torch.Tensor]]
_INT32_MAX = 2**31 - 1


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    return [t for group in tree.values() for t in group.values()]


def tree_unflatten(like: Tree, leaves: List[torch.Tensor]) -> Tree:
    it = iter(leaves)
    return {g: {k: next(it) for k in group} for g, group in like.items()}


def tree_map(fn: Callable, tree: Tree) -> Tree:
    return {g: {k: fn(t) for k, t in group.items()} for g, group in tree.items()}


@dataclass
class AdamState:
    """``count`` (int32 scalar), the moments ``mu`` and ``nu`` (trees like the
    params) and ``learning_rate`` (float32 scalar): the rate the last update
    used, optax's injected hyperparameter."""

    count: torch.Tensor
    mu: Tree
    nu: Tree
    learning_rate: torch.Tensor

    def replace(self, **kw) -> "AdamState":
        return dataclasses.replace(self, **kw)


def adam_init(params: Tree, learning_rate: float) -> AdamState:
    dev = tree_leaves(params)[0].device
    zeros = lambda t: torch.zeros_like(t)  # noqa: E731
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=dev),
                     mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                     learning_rate=torch.full((), learning_rate, dtype=torch.float32,
                                              device=dev))


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tree:
    """``optax.clip_by_global_norm(max_norm)`` applied to ``grads``."""
    leaves = tree_leaves(grads)
    sq = [(g * g).sum() for g in leaves]
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    norm = torch.sqrt(total)
    keep = norm < max_norm
    return tree_unflatten(grads, [torch.where(keep, g, (g / norm) * max_norm)
                                  for g in leaves])


def linear_schedule(learning_rate: float, updates_per_iteration: int,
                    num_iterations: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """``lr * max(1 - (count // updates_per_iteration) / num_iterations, 0)``
    (``gymca_tpu/agents/ppo.py:183-191``), on the count's device."""
    n_it = float(max(num_iterations, 1))

    def schedule(count: torch.Tensor) -> torch.Tensor:
        frac = 1.0 - (count // updates_per_iteration).to(torch.float32) / n_it
        return learning_rate * torch.clamp(frac, min=0.0)

    return schedule


def adam_update(grads: Tree, state: AdamState, params: Tree,
                learning_rate: Union[float, Callable[[torch.Tensor], torch.Tensor]],
                eps: float, b1: float = 0.9, b2: float = 0.999,
                max_grad_norm: Optional[float] = None):
    """One optimizer step: ``(new_params, new_state)``.  ``learning_rate`` is
    a constant or a schedule of the count; ``max_grad_norm`` clips first."""
    if max_grad_norm is not None:
        grads = clip_by_global_norm(grads, max_grad_norm)
    if callable(learning_rate):
        lr = learning_rate(state.count)
    else:
        lr = torch.full_like(state.learning_rate, learning_rate)
    g, mu, nu = tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu)
    mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1), torch._foreach_mul(mu, b1))
    nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                            torch._foreach_mul(nu, b2))
    count = torch.where(state.count < _INT32_MAX, state.count + 1, state.count)
    t = count.to(torch.float32)
    mu_hat = torch._foreach_div(mu, 1 - torch.pow(b1, t))
    nu_hat = torch._foreach_div(nu, 1 - torch.pow(b2, t))
    denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), eps)
    updates = torch._foreach_mul(torch._foreach_div(mu_hat, denom), -lr)
    new_params = torch._foreach_add(tree_leaves(params), updates)
    new_state = AdamState(count=count, mu=tree_unflatten(params, mu),
                          nu=tree_unflatten(params, nu), learning_rate=lr)
    return tree_unflatten(params, new_params), new_state
