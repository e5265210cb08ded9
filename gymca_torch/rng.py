"""``jax.random``'s key chain in torch, bit for bit.

The envs draw randomness where the JAX package does (the reset in
``BulldozerCore.initial_state`` and each step's gust roll), and so does the
PPO trainer (its Gumbel action draws and minibatch shuffles); those draws
must match the reference exactly.  This module reproduces jax 0.9.0's
``threefry2x32`` PRNG with ``jax_threefry_partitionable=True`` and x64 off
(``jax/_src/prng.py``: ``threefry_split``, ``threefry_fold_in``,
``_threefry_random_bits_partitionable``; ``jax/_src/random.py``: ``_uniform``,
``_randint``, ``choice`` with ``p``, ``_shuffle``).

Keys are ``(..., 2)`` tensors of key data: the two uint32 words of a jax key,
held in int64 (torch's uint32 arithmetic is incomplete on both CPU and CUDA).
Every function is vectorised over the leading key dimensions.

Every hash goes through :func:`threefry_launch`.  Keys on the CPU take its
plain version, :func:`threefry_plain`: the eager int64 hash, wrapped to 32
bits explicitly after every operation that can carry, which is also the
spec.  Keys on a CUDA device launch ``gymca_torch/csrc/threefry.cu``, one
launch per ``split``, ``fold_in``, ``random_bits``, ``uniform`` and
``randint`` (the inner split and both bit streams in the one launch);
``normal``, ``exponential``, ``poisson``, ``permutation`` and ``choice``
compose those with eager float, sort or search operations.

Inputs that no reference draw has to reproduce (random actions in the
smoke, test noise) come from a ``torch.Generator`` instead.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gymca_torch import _build
from gymca_torch.config import resolve_device
from gymca_torch.utils.metrics import span

__all__ = [
    "key",
    "threefry2x32",
    "threefry_launch",
    "threefry_plain",
    "split",
    "fold_in",
    "random_bits",
    "uniform",
    "randint",
    "exponential",
    "normal",
    "poisson",
    "xla_log",
    "permutation",
    "choice",
]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def key(seed: int, device=None) -> torch.Tensor:
    """Key data of ``jax.random.key(seed)`` for a seed in ``[0, 2**32)``, on
    ``device`` (the card unless the caller names another)."""
    if not 0 <= int(seed) <= _M32:
        raise ValueError(f"seed must lie in [0, 2**32), got {seed}")
    return torch.tensor([0, int(seed)], dtype=torch.int64,
                        device=resolve_device(device))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of counters ``(x1, x2)`` under key ``(k1, k2)``;
    all four broadcast together (``prng.py::_threefry2x32_lowering``)."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


# The forms a hash pass writes, by their code in csrc/threefry.cu: the
# element type, and the trailing dimensions an element adds.
_FORMS = {"keys": (0, torch.int64, (2,)), "bits": (1, torch.int64, ()),
          "uniform": (2, torch.float32, ()), "randint": (3, torch.int32, ())}


def threefry_plain(keys: torch.Tensor, count: int, form: str, *, base: int = 0,
                   minval=0.0, maxval=1.0) -> torch.Tensor:
    """:func:`threefry_launch`'s function in eager int64 torch ops, on any
    device; the CPU path and the spec of the kernel."""
    if form == "randint":
        pair = threefry_plain(keys, 2, "keys")
        higher = threefry_plain(pair[..., 0, :], count, "bits")
        lower = threefry_plain(pair[..., 1, :], count, "bits")
        return _randint_from_bits(higher, lower, minval, maxval)
    # the 64-bit iota of prng.py::iota_2x32_shape: high words 0 below 2**32
    lo = torch.arange(base, base + count, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(keys[..., 0, None], keys[..., 1, None], torch.zeros_like(lo), lo)
    if form == "keys":
        return torch.stack([b1, b2], dim=-1)
    if form == "bits":
        return b1 ^ b2
    return _uniform_from_bits(b1 ^ b2, minval, maxval)


@functools.cache
def _launcher():
    fn = _build.load("threefry").threefry_launch
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [ptr, i64, i64, i64, i64, ctypes.c_uint32, ctypes.c_int, ptr,
                   ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_uint32,
                   ctypes.c_uint32, ctypes.c_int32, ptr]
    fn.restype = ctypes.c_int
    return fn


def threefry_launch(keys: torch.Tensor, count: int, form: str, *, base: int = 0,
                    minval=0.0, maxval=1.0) -> torch.Tensor:
    """Threefry-2x32 of the counters ``base .. base + count - 1`` (high
    words 0) under each of the ``(..., 2)`` int64 ``keys``, in one pass.

    ``form`` says what the pass returns for each key and counter:
    ``"keys"``: ``(..., count, 2)`` int64 hash pairs (``split``, base 0;
    ``fold_in``, base ``data`` and count 1); ``"bits"``: ``(..., count)``
    int64 ``b1 ^ b2`` in ``[0, 2**32)``; ``"uniform"``: ``(..., count)``
    float32 in ``[minval, maxval)`` from those bits; ``"randint"``:
    ``(..., count)`` int32 in ``[minval, maxval)`` (the key's split and
    both bit streams of ``random.py::_randint``, base 0).

    Keys on the CPU take :func:`threefry_plain`.  Keys on a CUDA device
    launch ``csrc/threefry.cu`` on the current stream (strided keys read in
    place; ``threefry_launch.launches`` counts the host's launch calls, so
    a launch captured into a CUDA graph counts at its capture and not at
    the graph's replays, as in the trainer's policy; an empty result
    launches nothing) or raise."""
    if form not in _FORMS:
        raise ValueError(f"form must be one of {sorted(_FORMS)}, got {form!r}")
    if keys.dtype != torch.int64:
        raise ValueError(f"keys must be int64 key data, got {keys.dtype}")
    if keys.dim() < 1 or keys.shape[-1] != 2:
        raise ValueError(f"keys must have shape (..., 2), got {tuple(keys.shape)}")
    count, base = int(count), int(base)
    if count < 0 or base < 0 or base + count > 2**32:
        raise ValueError("more than 2**32 draws per key")
    if form == "randint" and not -(2**31) <= minval < maxval <= 2**31 - 1:
        raise ValueError(f"need int32 bounds with minval < maxval, got [{minval}, {maxval})")
    dev = keys.device
    if dev.type == "cpu":
        return threefry_plain(keys, count, form, base=base, minval=minval, maxval=maxval)
    if dev.type != "cuda":
        raise ValueError(f"threefry_launch runs on CPU or CUDA keys, got {dev}")
    if dev.index != torch.cuda.current_device():  # the kernel runs on the current device
        with torch.cuda.device(dev):
            return threefry_launch(keys, count, form, base=base, minval=minval,
                                   maxval=maxval)

    code, dtype, tail = _FORMS[form]
    lead = tuple(keys.shape[:-1])
    out = torch.empty(lead + (count,) + tail, dtype=dtype, device=dev)
    if out.numel() == 0:
        return out
    flat = keys if keys.dim() == 2 else keys.reshape(-1, 2)  # strided keys stay views
    lo = scale = 0.0
    affine = span = mult = imin = 0
    if form == "uniform":
        lo, scale = _affine(minval, maxval)
        affine = int((lo, scale) != (0.0, 1.0))
    elif form == "randint":
        imin, span = int(minval), int(maxval) - int(minval)
        mult = _randint_multiplier(span)
    # The current stream's handle as an int: torch.cuda.current_stream()
    # builds a Stream object, a third of a launch's host time on the card.
    err = _launcher()(
        flat.data_ptr(), flat.shape[0], flat.stride(0), flat.stride(1), count, base, code,
        out.data_ptr(), lo, scale, affine, span, mult, imin,
        torch._C._cuda_getCurrentRawStream(dev.index),
    )
    if err != 0:
        raise RuntimeError(f"threefry kernel launch failed: CUDA error {err}")
    threefry_launch.launches += 1
    return out


threefry_launch.launches = 0


def _shape(shape: Sequence[int]) -> Tuple[int, ...]:
    return tuple(int(d) for d in shape)


@span("rng")
def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` keys -> ``(..., num, 2)``."""
    return threefry_launch(keys, num, "keys")


@span("rng")
def fold_in(keys: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with a scalar ``data`` in ``[0, 2**32)``."""
    return threefry_launch(keys, 1, "keys", base=int(data) & _M32)[..., 0, :]


@span("rng")
def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element: ``(..., *shape)`` int64 in ``[0, 2**32)``
    (``prng.py::_threefry_random_bits_partitionable``, bit width 32)."""
    shape = _shape(shape)
    return threefry_launch(keys, math.prod(shape), "bits").reshape(keys.shape[:-1] + shape)


@span("rng")
def uniform(keys: torch.Tensor, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniform in ``[minval, maxval)`` (``random.py::_uniform``)."""
    shape = _shape(shape)
    return threefry_launch(keys, math.prod(shape), "uniform", minval=minval,
                           maxval=maxval).reshape(keys.shape[:-1] + shape)


@functools.lru_cache(maxsize=64)
def _affine(minval: float, maxval: float) -> Tuple[float, float]:
    """:func:`uniform`'s float32 ``minval`` and ``maxval - minval``, held in
    Python floats: no host-to-device copy."""
    return float(np.float32(minval)), float(np.float32(maxval) - np.float32(minval))


def _uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                       maxval: float = 1.0) -> torch.Tensor:
    """:func:`uniform`'s values from its 32 random bits per element."""
    float_bits = (bits >> 9) | 0x3F800000  # mantissa bits under exponent 0
    floats = float_bits.to(torch.int32).view(torch.float32) - 1.0
    lo, scale = _affine(minval, maxval)
    if (lo, scale) == (0.0, 1.0):
        return floats
    # XLA fuses floats * scale + lo into one multiply-add, which rounds once.
    return torch.clamp(_fma_f32(floats.double() * scale, lo), min=lo)


def _fma_f32(p: torch.Tensor, c: float) -> torch.Tensor:
    """float32 ``p + c`` rounded once from the exact sum, for float64 ``p``
    exact (a product of two float32 values) and float32 ``c``.

    The float64 sum ``s`` rounds, and where it lands on a float32 halfway
    point the cast would tie to even whichever side the exact sum lay on.
    There the TwoSum error ``e`` says which side: ``s`` moves one float64
    step toward it first.  Results below float32's normal range are not
    handled (no caller draws them)."""
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    # halfway: the 29 float64 mantissa bits a float32 drops are 1 followed
    # by zeros
    halfway = (s.view(torch.int64) & ((1 << 29) - 1)) == (1 << 28)
    toward = torch.where(e > 0, math.inf, -math.inf).to(s.dtype)
    s = torch.where(halfway & (e != 0), torch.nextafter(s, toward), s)
    return s.float()


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b`` modulo 2**32 for operands below 2**32, with no int64
    overflow on the way."""
    b_lo, b_hi = b & 0xFFFF, b >> 16
    return (a * b_lo + (((a * b_hi) & 0xFFFF) << 16)) & _M32


def _randint_multiplier(span: int) -> int:
    """``random.py::_randint``'s multiplier: ``(2**16 % span)**2`` as a
    uint32 product, modulo ``span``."""
    multiplier = 2**16 % span
    return ((multiplier * multiplier) & _M32) % span  # uint32 product


def _randint_from_bits(higher: torch.Tensor, lower: torch.Tensor, minval: int,
                      maxval: int) -> torch.Tensor:
    """:func:`randint`'s values from its two bit streams."""
    span = maxval - minval
    multiplier = _randint_multiplier(span)
    offset = (_mul32(higher % span, multiplier) + lower % span) & _M32
    return (minval + offset % span).to(torch.int32)


@span("rng")
def randint(keys: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """int32 draws in ``[minval, maxval)`` (``random.py::_randint``)."""
    shape = _shape(shape)
    return threefry_launch(keys, math.prod(shape), "randint", minval=minval,
                           maxval=maxval).reshape(keys.shape[:-1] + shape)


def _f32(bits: int) -> float:
    """The float32 whose bit pattern is ``bits``, as a Python float."""
    return float(np.array(bits, np.uint32).view(np.float32))


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once: the float64 product of two float32
    values is exact, so only the add rounds before the cast (double rounding
    never changes a result on the inputs :func:`_log1p_neg` sees)."""
    def wide(t):
        return t.double() if isinstance(t, torch.Tensor) else t
    return (wide(a) * wide(b) + wide(c)).float()


# XLA's CPU log1p in float32 (jax 0.9.0): a Cephes rational approximation
# for |x| < sqrt(2) - 1 and a Cephes-style logf of 1 + x elsewhere, with the
# multiply-adds that LLVM contracts into fused multiply-adds.  Constants are
# the float32 bit patterns of the compiled code.
_LOG1P_SMALL = 0x3ED413CD  # sqrt(2) - 1
_LOG1P_DEN = (0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3, 0x43586D8A, 0x42707982)
_LOG1P_NUM = (0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76, 0x426473AD,
              0x41A05101)
_LOGF_SQRTHF = 0x3F3504F3
_LOGF_P = ((0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A), (0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50),
           (0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA))
_LOGF_Q1, _LOGF_Q2 = 0xB95E8083, 0x3F318000


def _log1p_neg(u: torch.Tensor) -> torch.Tensor:
    """``log1p(-u)`` for float32 ``u`` in [0, 1), rounded as XLA's CPU backend
    rounds ``jnp.log1p(-u)``: equal on all 2**23 values a uniform draw takes."""
    # |x| small: x + (-x**2 / 2 + x**3 * P(x) / Q(x)) at x = -u.
    den = torch.ones_like(u)
    for c in _LOG1P_DEN:
        den = _fma(-den, u, _f32(c))
    num = torch.full_like(u, _f32(_LOG1P_NUM[0]))
    for c in _LOG1P_NUM[1:]:
        num = _fma(-num, u, _f32(c))
    u2 = u * u
    small = (u2 * -0.5 + (u2 * -u) * (num / den)) - u
    return torch.where(u.abs() < _f32(_LOG1P_SMALL), small, _logf(1.0 - u))


def _logf(v: torch.Tensor) -> torch.Tensor:
    """The Cephes-style float32 ``log`` of XLA's CPU backend for normal
    ``v > 0`` (smaller values are read as the least normal): the mantissa m
    in [sqrt(1/2), sqrt(2)) and the exponent e, as log(m) + e * ln 2 with
    ln 2 split in two."""
    bits = torch.clamp(v, min=_f32(0x00800000)).view(torch.int32)
    mant = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    below = mant < _f32(_LOGF_SQRTHF)
    e = ((bits >> 23) & 0xFF).to(torch.float32) - 126.0 - below.to(torch.float32)
    x = (mant - 1.0) + torch.where(below, mant, torch.zeros_like(mant))
    z = x * x
    x_cubed = z * x
    p = [_fma(_fma(x, _f32(c0), _f32(c1)), x, _f32(c2)) for c0, c1, c2 in _LOGF_P]
    y = _fma(_fma(_fma(p[0], x_cubed, p[1]), x_cubed, p[2]), x_cubed, e * _f32(_LOGF_Q1))
    return ((x - z * 0.5) + y) + e * _f32(_LOGF_Q2)


def xla_log(v: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` rounded as XLA's CPU backend rounds ``jnp.log``, for
    zero, infinity and normal ``v > 0``: equal on all 2**23 values a uniform
    draw takes and on their negated logs (a Gumbel draw's two logs).
    torch's own ``log`` differs from it in the last bit on about one value
    in seven of those."""
    out = torch.where(v == 0, -math.inf, _logf(v))
    return torch.where(torch.isinf(v), v, out)


@span("rng")
def exponential(keys: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """float32 Exp(1) draws (``random.py::_exponential``): ``-log1p(-u)``
    with ``log1p`` as XLA's CPU backend rounds it."""
    return -_log1p_neg(uniform(keys, shape))


# XLA's float32 ErfInv (Giles' single-precision approximation): a degree-8
# polynomial in w - 2.5 for w = -log1p(-x**2) < 5, else in sqrt(w) - 3,
# evaluated by Horner steps that LLVM contracts into fused multiply-adds.
_ERFINV_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2)))


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``erf_inv`` rounded as XLA's CPU backend rounds
    ``lax.erf_inv`` on ``x`` in (-1, 1) (and ``±inf`` at ``±1``)."""
    w = -_log1p_neg(x * x)
    lt = w < 5.0
    # float64 sqrt rounded to float32 is the correctly rounded float32 sqrt
    wp = torch.where(lt, w - 2.5, w.double().sqrt().float() - 3.0)
    lt_c = [float(np.float32(c)) for c in _ERFINV_W_LT5]
    ge_c = [float(np.float32(c)) for c in _ERFINV_W_GE5]
    p = torch.where(lt, lt_c[0], ge_c[0])
    for c_lt, c_ge in zip(lt_c[1:], ge_c[1:]):
        p = _fma_f32(p.double() * wp.double(), torch.where(lt, c_lt, c_ge))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """:func:`normal`'s values from its 32 random bits per element."""
    return _SQRT2_F32 * _erf_inv(_uniform_from_bits(bits, _NORMAL_LO, 1.0))


@span("rng")
def normal(keys: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """float32 standard normal draws (``random.py::_normal_real``):
    ``sqrt(2) * erf_inv(u)`` for ``u`` uniform in ``[nextafter(-1, 0), 1)``."""
    return _normal_from_bits(random_bits(keys, shape))


@span("rng")
def poisson(keys: torch.Tensor, lam: float, shape: Sequence[int] = (),
            max_count: Optional[int] = None) -> torch.Tensor:
    """int32 Poisson(``lam``) draws for ``lam`` < 10 (``random.py::
    _poisson_knuth``): each round splits the key, draws a float32 uniform
    field and adds its ``log`` to a running float32 sum; the count is the
    number of rounds whose partial sum stays above ``-lam``.

    With ``max_count=m`` exactly ``m`` rounds are drawn, which gives
    ``min(poisson, m)`` bit for bit and never waits for the device.  Without
    it the loop runs until every cell's sum has fallen to ``-lam``, with a
    host check of that each round."""
    if not 0.0 < lam < 10.0:
        raise ValueError(f"only Knuth's branch (0 < lam < 10) is ported, got {lam}")
    neg_lam = float(np.float32(-lam))
    shape = tuple(int(d) for d in shape)
    log_prod = torch.zeros(keys.shape[:-1] + shape, dtype=torch.float32,
                           device=keys.device)
    count = torch.zeros(log_prod.shape, dtype=torch.int32, device=keys.device)
    rounds = 0
    while (rounds < max_count) if max_count is not None else bool((log_prod > neg_lam).any()):
        pair = split(keys)
        keys = pair[..., 0, :]
        log_prod = log_prod + xla_log(uniform(pair[..., 1, :], shape))
        count = count + (log_prod > neg_lam).to(torch.int32)
        rounds += 1
    return count


@span("rng")
def permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: a permutation of ``0 .. n-1``
    (int64, on the key's device) for one ``(2,)`` key.

    ``random.py::_shuffle``: ``ceil(3 ln n / ln(2**32 - 1))`` rounds, each a
    split, 32 random bits per element and a stable sort of the elements by
    them.  An array of any rank is permuted along its first axis with the
    same key by indexing with this permutation: JAX's 1-D shuffle sorts the
    values by the same bits, and a stable sort moves values as it moves
    indices."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_M32)))
    perm = torch.arange(n, dtype=torch.int64, device=keys.device)
    for _ in range(rounds):
        pair = split(keys)
        keys = pair[0]
        order = torch.sort(random_bits(pair[1], (n,)), stable=True).indices
        perm = perm[order]
    return perm


@functools.lru_cache(maxsize=64)
def _cumulative(p: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """float32 cumulative sum of ``p``, summed in order on the host and
    copied to ``device`` once: later draws make no host-to-device copy, which
    would make the host wait for the device."""
    return torch.cumsum(torch.tensor(p, dtype=torch.float32), 0).to(device)


@span("rng")
def choice(keys: torch.Tensor, n: int, shape: Sequence[int],
           p: Sequence[float]) -> torch.Tensor:
    """Indices in ``[0, n)`` drawn with replacement with probabilities ``p``
    (``random.py::choice`` with ``p`` and ``replace=True``): a float32
    cumulative sum, ``p_cuml[-1] * (1 - u)``, then a left ``searchsorted``.
    Returns int64 indices of shape ``(..., *shape)``."""
    p = tuple(float(x) for x in p)
    if len(p) != n:
        raise ValueError(f"p must have shape ({n},), got ({len(p)},)")
    p_cuml = _cumulative(p, keys.device)
    r = p_cuml[-1] * (1.0 - uniform(keys, shape))
    return torch.searchsorted(p_cuml, r.reshape(-1)).reshape(r.shape)
