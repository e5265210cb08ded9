"""PPO model family: IMPALA-style CNN torso + categorical actor heads + critic.

Counterpart of ``gymca_tpu/agents/networks.py``, as ``nn.Module``s:

* ``Network``: grid/255 -> 5x5 stride-2 conv(64) -> ConvSequence(16, 32, 64)
  -> relu -> flatten -> Dense(128) -> relu.  ``ConvSequence`` = 3x3 conv +
  3x3/2 max pool + 2 residual blocks.
* ``Actor``: 2x Dense(128) -> one categorical head per action dim (9 moves,
  2 shoot) + one head per extension registry with ``sum_{i<=k} C(n, i)``
  combination logits.
* ``Critic``: 2x Dense(128) -> scalar value.

The modules take the env's NHWC grid (uint8 or float32) and compute as flax
does, so weights carried from the JAX package give the same outputs:

* submodules carry flax's names (``Conv_0``, ``ConvSequence_1``,
  ``ResidualBlock_0``, ``Dense_2``), so a state-dict key is a flax param path
  (``kernel`` named ``weight``); :func:`param_dict` lists them in flax's leaf
  order (``gymca_torch.interop.ppo_params_from_numpy`` carries them);
* conv weights are OIHW and dense weights (out, in), flax's HWIO and
  (in, out) transposed;
* ``grid / 255.0`` is a multiply by the float32 reciprocal, as XLA folds that
  division under ``jit``;
* the max pool pads "SAME" as flax does, asymmetrically with -inf (low =
  total // 2): at 256² the pools see 126 -> 63 (pad 0, 1), 63 -> 32 (1, 1)
  and 32 -> 16 (0, 1);
* the torso flattens in NHWC order, so the first Dense's rows are flax's;
* ``compute_dtype=torch.bfloat16`` casts inputs, weights and biases to
  bfloat16 inside each layer and adds the bias after the conv, as flax's
  promotion does; the torso's output returns to float32 and the params stay
  float32.

Init: ``ConvSequence``'s first conv keeps flax's default (lecun-normal
kernel, zero bias); every other layer is orthogonal with gain sqrt(2), 1 or
0.01 and a zero bias.  The draws come from a ``torch.Generator`` on the CPU,
so one seed gives the same weights on every device; they are not flax's
draws (parity runs on carried weights).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Network", "Actor", "Critic", "ResidualBlock", "ConvSequence", "param_dict",
           "torso_width"]

_INV_255 = float(np.float32(1.0) / np.float32(255.0))
_SQRT2 = math.sqrt(2.0)


def _orthogonal(w: torch.Tensor, gain: float, gen: Optional[torch.Generator]):
    nn.init.orthogonal_(w, gain=gain, generator=gen)


def _lecun_normal(w: torch.Tensor, gen: Optional[torch.Generator]):
    """flax's ``lecun_normal``: a normal truncated at two standard deviations,
    scaled to variance 1 / fan_in."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


class Conv(nn.Module):
    """flax ``nn.Conv`` with a square kernel: symmetric ``padding`` (1 for a
    3x3 "SAME", 0 for "VALID"), the bias added after the conv."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 gain: Optional[float] = None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        with torch.no_grad():
            if gain is None:
                _lecun_normal(self.weight, generator)
            else:
                _orthogonal(self.weight, gain, generator)

    def forward(self, x):
        w, b = self.weight.to(self.dtype), self.bias.to(self.dtype)
        y = F.conv2d(x.to(self.dtype), w, None, self.stride, self.padding)
        return y + b[:, None, None]


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias``, orthogonal kernel, zero bias."""

    def __init__(self, cin: int, cout: int, gain: float, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        with torch.no_grad():
            _orthogonal(self.weight, gain, generator)

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


def _same_pad(n: int, k: int = 3, stride: int = 2) -> Tuple[int, int]:
    """flax/XLA "SAME" padding of one axis: (low, high), low = total // 2."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """``nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")`` on NCHW."""
    top, bottom = _same_pad(x.shape[-2])
    left, right = _same_pad(x.shape[-1])
    x = F.pad(x, (left, right, top, bottom), value=-math.inf)
    return F.max_pool2d(x, 3, 2)


class ResidualBlock(nn.Module):
    def __init__(self, channels: int, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = Conv(channels, channels, 3, padding=1, gain=_SQRT2, dtype=dtype,
                           generator=generator)
        self.Conv_1 = Conv(channels, channels, 3, padding=1, gain=_SQRT2, dtype=dtype,
                           generator=generator)

    def forward(self, x):
        y = self.Conv_1(F.relu(self.Conv_0(F.relu(x))))
        return y + x


class ConvSequence(nn.Module):
    def __init__(self, cin: int, channels: int, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = Conv(cin, channels, 3, padding=1, dtype=dtype, generator=generator)
        self.ResidualBlock_0 = ResidualBlock(channels, dtype, generator)
        self.ResidualBlock_1 = ResidualBlock(channels, dtype, generator)

    def forward(self, x):
        x = max_pool_same(self.Conv_0(x))
        return self.ResidualBlock_1(self.ResidualBlock_0(x))


def torso_width(height: int, width: int, channels: Sequence[int] = (16, 32, 64)) -> int:
    """Length of the flattened torso features for an ``height x width`` grid."""
    h, w = (height - 5) // 2 + 1, (width - 5) // 2 + 1
    for _ in channels:
        h, w = -(-h // 2), -(-w // 2)
    return h * w * channels[-1]


class Network(nn.Module):
    """Shared CNN torso over the (N, H, W, 3) RGB grid observation, for grids
    of ``height x width``.  The JAX module's ``conv_count`` and
    ``maxpool_count`` fields change nothing there and have no counterpart."""

    def __init__(self, height: int, width: int, channels: Tuple[int, ...] = (16, 32, 64),
                 compute_dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.Conv_0 = Conv(3, 64, 5, stride=2, gain=_SQRT2, dtype=compute_dtype,
                           generator=generator)
        cin = 64
        for i, c in enumerate(channels):
            setattr(self, f"ConvSequence_{i}", ConvSequence(cin, c, compute_dtype, generator))
            cin = c
        self._n_seq = len(channels)
        self.Dense_0 = Dense(torso_width(height, width, channels), 128, _SQRT2,
                             compute_dtype, generator)

    def forward(self, grid):
        x = (grid.to(torch.float32) * _INV_255).to(self.compute_dtype)
        x = F.relu(self.Conv_0(x.permute(0, 3, 1, 2)))
        for i in range(self._n_seq):
            x = getattr(self, f"ConvSequence_{i}")(x)
        x = F.relu(x).permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return F.relu(self.Dense_0(x)).to(torch.float32)


class Critic(nn.Module):
    def __init__(self, in_features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Dense_0 = Dense(in_features, 128, _SQRT2, generator=generator)
        self.Dense_1 = Dense(128, 128, _SQRT2, generator=generator)
        self.Dense_2 = Dense(128, 1, 1.0, generator=generator)

    def forward(self, x):
        return self.Dense_2(F.relu(self.Dense_1(F.relu(self.Dense_0(x)))))


class Actor(nn.Module):
    """Multi-head categorical actor.

    ``action_dims``: sizes of the plain categorical heads (e.g. (9, 2)).
    ``choose_k``: (n, k) per extension registry — adds a head with
    ``sum_{i<=k} C(n, i)`` combination logits.  Returns a list of (N, dim)
    logits, one per head.
    """

    def __init__(self, in_features: int, action_dims: Sequence[int],
                 choose_k: Sequence[Tuple[int, int]] = (),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Dense_0 = Dense(in_features, 128, _SQRT2, generator=generator)
        self.Dense_1 = Dense(128, 128, _SQRT2, generator=generator)
        dims = [int(d) for d in action_dims] + [
            sum(math.comb(n, i) for i in range(k + 1)) for n, k in choose_k]
        for i, d in enumerate(dims):
            setattr(self, f"Dense_{2 + i}", Dense(128, d, 0.01, generator=generator))
        self.head_dims = tuple(dims)

    def forward(self, x):
        x = F.relu(self.Dense_1(F.relu(self.Dense_0(x))))
        return [getattr(self, f"Dense_{2 + i}")(x) for i in range(len(self.head_dims))]


def _flax_path(name: str) -> Tuple[str, ...]:
    *mods, leaf = name.split(".")
    return tuple(mods) + ("kernel" if leaf == "weight" else leaf,)


def param_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's parameters, detached, keyed by state-dict name, in the
    order of the flax tree's leaves (sorted paths)."""
    items = sorted(module.named_parameters(), key=lambda kv: _flax_path(kv[0]))
    return {k: v.detach() for k, v in items}
