"""Terrain generation for the Advanced Bulldozer env, over a batch of envs.

Counterpart of ``gymca_tpu/envs/terrain.py``:

* vegetation / density: random rectangular patches of type 1..5, leftover
  cells filled with 1..3;
* altitude: uniform noise + cosine hills + linear slopes, /10;
* per-cell 3x3 slope tensor ``degrees(atan(dalt))`` with diagonals /1.414,
  flat borders, zero centre;
* 8 directional 3x3 wind matrices ``exp(c1*V) * exp(V*c2*(cos(theta)-1))``,
  V=10, c1=0.045, c2=0.131;
* ``create_up_to_k_mappings`` for extension-combination action ids.

Every field is drawn from ``(N, 2)`` key data with the JAX package's key
chain, one env per key, and equals it bit for bit.  Altitude, slope and the
Alexandridis ``exp_slope`` go through float32 ``cos``, ``arctan`` and
``exp``, which XLA's CPU backend does not round correctly: :func:`xla_cos`,
:func:`xla_atan` and :func:`xla_exp` reproduce its results (glibc's
``cosf`` and ``atan2f(x, 1)``, which XLA calls, and XLA's own inlined
``exp``) with plain torch ops, on the CPU and the card alike.  The divisions
by constants are multiplications by the float32 reciprocal, as XLA folds
them in the env's jitted terrain, and the hills' square root goes through
float64 (torch's CPU float32 ``sqrt`` is not correctly rounded).  The env's
slope follows the fused multiply-subtracts of XLA's code for the jitted
bundle (:func:`bundle_slope`); :func:`get_slope` is ``get_slope`` jitted
alone.  The quirk of the reference is kept:
``get_winds(use_hidden)``'s non-hidden branch is dead, all 8 directional
matrices are returned regardless.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from gymca_torch import rng
from gymca_torch.config import TYPE_BOX, TYPE_INT, resolve_device

__all__ = [
    "init_vegetation",
    "init_density",
    "init_altitude",
    "init_altitude_and_slope",
    "init_vegetation_same",
    "init_density_same",
    "init_altitude_same",
    "get_slope",
    "bundle_slope",
    "get_winds",
    "calc_pw",
    "create_up_to_k_mappings",
    "WIND_THETAS",
    "xla_cos",
    "xla_atan",
    "xla_exp",
]

MAX_PATCHES = 7  # the reference draws randint(4, 8) patches
MAX_HILLS = 9  # randint(6, 10) hills
MAX_SLOPES = 7  # randint(4, 8) slopes
_RECIP_10 = float(np.float32(1.0) / np.float32(10.0))
_RECIP_1414 = float(np.float32(1.0) / np.float32(1.414))


# --- float32 transcendentals as the JAX package's CPU backend rounds them -----------

# glibc's cosf (sysdeps/ieee754/flt-32/s_cosf.c, sincosf.h): double
# arithmetic, a reduction by pi/2 and even/odd polynomials, rounded once.
_COSF_C = tuple(map(float.fromhex, ("0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
                                     "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16")))
_COSF_S = tuple(map(float.fromhex, ("-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
                                     "-0x1.994eb3774cf24p-13")))
_COSF_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")  # 2 / pi * 2**24
_COSF_HPI = float.fromhex("0x1.921FB54442D18p0")


def _cos_poly(x2: torch.Tensor, sign) -> torch.Tensor:
    x4 = x2 * x2
    c2 = sign * _COSF_C[3] + x2 * (sign * _COSF_C[4])
    c1 = sign * _COSF_C[0] + x2 * (sign * _COSF_C[1])
    return (c1 + x4 * (sign * _COSF_C[2])) + (x4 * x2) * c2


def _sin_poly(x: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    x3 = x * x2
    s1 = _COSF_S[1] + x2 * _COSF_S[2]
    return (x + x3 * _COSF_S[0]) + (x3 * x2) * s1


def xla_cos(y: torch.Tensor) -> torch.Tensor:
    """float32 ``cos`` as ``jnp.cos`` rounds it on the CPU (glibc 2.36's
    ``cosf``), for |y| < 120: the terrain's hills feed it [0, pi/2).  Larger
    arguments take glibc's slow reduction, not reproduced: torch's ``cos``."""
    top = (y.view(torch.int32) >> 20) & 0x7FF  # glibc's abstop12
    x = y.double()
    small = _cos_poly(x * x, 1.0)
    n = ((x * _COSF_HPI_INV).to(torch.int32) + 0x800000) >> 24  # the quadrant
    r = x - n.double() * _COSF_HPI
    sign = torch.where((n & 2) > 0, -1.0, 1.0).double()  # the table's sign
    odd = (n & 1) > 0  # sine polynomial, of r * sign[n & 3]
    reduced = torch.where(odd, _sin_poly(r * torch.where(odd, -sign, sign), r * r),
                          _cos_poly(r * r, sign))
    out = torch.where(top < 0x3F4, small, reduced).float()  # |y| < 0.75: no reduction
    out = torch.where(top < 0x398, torch.ones_like(out), out)  # |y| < 2**-12
    return torch.where(top < 0x42F, out, torch.cos(y))  # |y| < 120


# glibc's atanf (sysdeps/ieee754/flt-32/s_atanf.c; atan2f(y, 1) calls it):
# float32 arithmetic, constants as compiled into glibc 2.36's libm.
_ATANF_HI = (0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA)
_ATANF_LO = (0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168)
_ATANF_T = (0x3EAAAAAB, 0xBE4CCCCD, 0x3E124925, 0xBDE38E38, 0x3DBA2E6E, 0xBD9D8795,
            0x3D886B35, 0xBD6EF16B, 0x3D4BDA59, 0xBD15A221, 0x3C8569D7)


def xla_atan(x: torch.Tensor) -> torch.Tensor:
    """float32 ``arctan`` as ``jnp.arctan`` rounds it on the CPU: XLA lowers
    it to ``atan2f(x, 1)``, which is glibc 2.36's ``atanf``; finite x."""
    ix = x.view(torch.int32) & 0x7FFFFFFF
    a = x.abs()
    band = ((ix >= 0x3EE00000).int() + (ix >= 0x3F300000).int() + (ix >= 0x3F980000).int()
            + (ix >= 0x401C0000).int()) - 1  # -1: |x| < 7/16; 0..3: the four reductions
    xr = torch.where(band == 0, (2.0 * a - 1.0) / (a + 2.0), x)
    xr = torch.where(band == 1, (a - 1.0) / (a + 1.0), xr)
    xr = torch.where(band == 2, (a - 1.5) / (a * 1.5 + 1.0), xr)
    xr = torch.where(band == 3, -1.0 / a, xr)
    t = [rng._f32(b) for b in _ATANF_T]
    z = xr * xr
    w = z * z
    s1 = t[10]
    for c in t[8::-2]:
        s1 = s1 * w + c
    s2 = t[9]
    for c in t[7::-2]:
        s2 = s2 * w + c
    s = s1 * z + s2 * w
    small = xr - s * xr
    hi, lo = (torch.full_like(x, rng._f32(tab[3])) for tab in (_ATANF_HI, _ATANF_LO))
    for i in range(3):
        hi = torch.where(band == i, rng._f32(_ATANF_HI[i]), hi)
        lo = torch.where(band == i, rng._f32(_ATANF_LO[i]), lo)
    big = hi - ((s * xr - lo) - xr)
    big = torch.where(x < 0, -big, big)
    return torch.where(ix < 0x31000000, x, torch.where(band < 0, small, big))


# XLA's inlined float32 exp (a Cephes polynomial), with the multiply-adds
# LLVM contracts into fused multiply-adds; constants as compiled.
_EXPF_P = (0x39506967, 0x3AB743CE, 0x3C088908, 0x3D2AA9C1, 0x3E2AAAAA)


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` as ``jnp.exp`` rounds it on the CPU: equal on every
    float32 in [-7.1, 7.1] (``exp(0.078 * slope)`` takes [-7.02, 7.02])."""
    f = rng._f32
    x = torch.clamp(x, min=f(0xC2AF999A), max=f(0x42B1999A))
    fx = torch.floor(rng._fma(x, f(0x3FB8AA3B), 0.5)).clamp(-127.0, 127.0)
    x = rng._fma(-fx, f(0x3F318000), x)
    x = rng._fma(-fx, f(0xB95E8083), x)
    y = rng._fma(f(_EXPF_P[0]), x, f(_EXPF_P[1]))
    for c in _EXPF_P[2:]:
        y = rng._fma(y, x, f(c))
    y = rng._fma(y, x, 0.5)
    y = rng._fma(y, x * x, x) + 1.0
    return y * ((fx.int() + 127) << 23).view(torch.float32)


def _scalar(keys, lo: int, hi: int) -> torch.Tensor:
    """One int32 draw in [lo, hi) per key, shaped (N, 1, 1) to broadcast
    over a lattice."""
    return rng.randint(keys, (), lo, hi)[:, None, None]


def _patch_field(keys: torch.Tensor, nrows: int, ncols: int) -> torch.Tensor:
    """Patch maps of ``len(keys)`` envs: sequential random rectangles of type
    1..5, zeros backfilled with 1..3."""
    sub = rng.split(keys, 2 + MAX_PATCHES)
    k_n, k_fill, k_patch = sub[:, 0], sub[:, 1], sub[:, 2]
    num_patches = rng.randint(k_n, (), 4, 8)[:, None, None]
    rows = torch.arange(nrows, dtype=TYPE_INT, device=keys.device)[:, None]
    cols = torch.arange(ncols, dtype=TYPE_INT, device=keys.device)[None, :]
    field = torch.zeros((keys.shape[0], nrows, ncols), dtype=TYPE_INT,
                        device=keys.device)
    for i in range(MAX_PATCHES):
        k = rng.split(rng.fold_in(k_patch, i), 5)
        center_row = _scalar(k[:, 0], 0, nrows)
        center_col = _scalar(k[:, 1], 0, ncols)
        patch_h = _scalar(k[:, 2], 3, max(nrows // 2, 4))
        patch_w = _scalar(k[:, 3], 3, max(ncols // 2, 4))
        ptype = _scalar(k[:, 4], 1, 6)
        inside = ((rows >= center_row - patch_h // 2)
                  & (rows < center_row + patch_h // 2)
                  & (cols >= center_col - patch_w // 2)
                  & (cols < center_col + patch_w // 2))
        field = torch.where((i < num_patches) & inside, ptype, field)
    filler = rng.randint(k_fill, (nrows, ncols), 1, 4)
    return torch.where(field == 0, filler, field).to(TYPE_INT)


def init_vegetation(key, nrows: int, ncols: int, num_envs: int) -> torch.Tensor:
    """(num_envs, H, W) int32 vegetation types from one (2,) key."""
    return _patch_field(rng.split(key, num_envs), nrows, ncols)


def init_density(key, nrows: int, ncols: int, num_envs: int) -> torch.Tensor:
    """(num_envs, H, W) int32 density types from one (2,) key."""
    return _patch_field(rng.split(key, num_envs), nrows, ncols)


def _altitude_sum(keys: torch.Tensor, nrows: int, ncols: int) -> torch.Tensor:
    """The float32 sums, before the /10, of the altitudes of ``len(keys)``
    envs: noise + cosine hills + linear slopes."""
    sub = rng.split(keys, 5)
    k_base, k_nh, k_hills, k_ns, k_slopes = (sub[:, i] for i in range(5))
    alt = rng.uniform(k_base, (nrows, ncols), minval=0.0, maxval=5.0)
    rows = torch.arange(nrows, device=keys.device).to(TYPE_BOX)[:, None]
    cols = torch.arange(ncols, device=keys.device).to(TYPE_BOX)[None, :]

    num_hills = rng.randint(k_nh, (), 6, 10)[:, None, None]
    max_radius = max(min(nrows, ncols) // 4, 3)
    for i in range(MAX_HILLS):
        k = rng.split(rng.fold_in(k_hills, i), 4)
        cr = _scalar(k[:, 0], 0, nrows).to(TYPE_BOX)
        cc = _scalar(k[:, 1], 0, ncols).to(TYPE_BOX)
        radius = _scalar(k[:, 2], 2, max_radius).to(TYPE_BOX)
        height = rng.uniform(k[:, 3], (), minval=2.0, maxval=6.0)[:, None, None]
        # float32 sqrt through float64: torch's CPU float32 sqrt is not correctly rounded
        dist = torch.sqrt(((rows - cr) ** 2 + (cols - cc) ** 2).double()).float()
        factor = xla_cos(dist / radius * math.pi / 2)
        bump = torch.where(dist < radius, height * factor, 0.0)
        alt = alt + torch.where(i < num_hills, bump, 0.0)

    num_slopes = rng.randint(k_ns, (), 4, 8)[:, None, None]
    for i in range(MAX_SLOPES):
        k = rng.split(rng.fold_in(k_slopes, i), 5)
        start_row = _scalar(k[:, 0], 0, max(nrows - 4, 1))
        start_col = _scalar(k[:, 1], 0, max(ncols - 4, 1))
        width = _scalar(k[:, 2], 3, max(ncols // 4, 4))
        height = _scalar(k[:, 3], 3, max(nrows // 4, 4))
        height_diff = rng.uniform(k[:, 4], (), minval=1.0, maxval=4.0)[:, None, None]
        inside = ((rows >= start_row) & (rows < start_row + height)
                  & (cols >= start_col) & (cols < start_col + width))
        progress = (rows - start_row.to(TYPE_BOX)) / torch.clamp(
            height.to(TYPE_BOX), min=1.0)
        ramp = torch.where(inside, height_diff * progress, 0.0)
        alt = alt + torch.where(i < num_slopes, ramp, 0.0)
    return alt


def _altitude_field(keys: torch.Tensor, nrows: int, ncols: int) -> torch.Tensor:
    """Altitudes of ``len(keys)`` envs: noise + cosine hills + linear
    slopes, /10."""
    # / 10 as the env's jitted terrain computes it: XLA folds a division by a
    # constant into a multiplication by its float32 reciprocal.
    return (_altitude_sum(keys, nrows, ncols) * _RECIP_10).to(TYPE_BOX)


def init_altitude(key, nrows: int, ncols: int, num_envs: int) -> torch.Tensor:
    """(num_envs, H, W) float32 altitudes from one (2,) key."""
    return _altitude_field(rng.split(key, num_envs), nrows, ncols)


def init_altitude_and_slope(key, nrows: int, ncols: int, num_envs: int):
    """``(altitude, slope)`` from one (2,) key as the Advanced env's jitted
    terrain bundle computes them: :func:`init_altitude`'s altitudes and
    :func:`bundle_slope`'s slopes."""
    alt_sum = _altitude_sum(rng.split(key, num_envs), nrows, ncols)
    altitude = (alt_sum * _RECIP_10).to(TYPE_BOX)
    return altitude, bundle_slope(alt_sum, altitude)


# Uniform (non-hidden) variants.
def init_density_same(nrows, ncols, num_envs, device=None):
    return torch.full((num_envs, nrows, ncols), 3, dtype=TYPE_INT,
                      device=resolve_device(device))


def init_vegetation_same(nrows, ncols, num_envs, device=None):
    return torch.full((num_envs, nrows, ncols), 3, dtype=TYPE_INT,
                      device=resolve_device(device))


def init_altitude_same(nrows, ncols, num_envs, device=None):
    return torch.zeros((num_envs, nrows, ncols), dtype=TYPE_BOX,
                       device=resolve_device(device))


def get_slope(altitude: torch.Tensor) -> torch.Tensor:
    """Per-cell 3x3 slope tensor, (..., H, W) -> (..., H, W, 3, 3):
    ``slope[..., r, c, i, j] = degrees(atan((alt[r,c] - alt[r+i-1, c+j-1]) /
    (1.414 if diagonal)))``; border cells stay all-zero, the centre is 0."""
    h, w = altitude.shape[-2:]
    lead = altitude.shape[:-2]
    padded = torch.nn.functional.pad(
        altitude.reshape(-1, 1, h, w), (1, 1, 1, 1), mode="replicate"
    ).reshape(lead + (h + 2, w + 2))
    out = []
    for di in (-1, 0, 1):
        row_entries = []
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                row_entries.append(torch.zeros_like(altitude))
                continue
            neigh = padded[..., 1 + di:1 + di + h, 1 + dj:1 + dj + w]
            diff = altitude - neigh
            if di != 0 and dj != 0:
                diff = diff * _RECIP_1414  # / 1.414, folded as XLA folds it
            row_entries.append(torch.rad2deg(xla_atan(diff)))
        out.append(torch.stack(row_entries, dim=-1))
    slope = torch.stack(out, dim=-2)  # (..., H, W, 3, 3)
    rows = torch.arange(h, device=altitude.device)
    cols = torch.arange(w, device=altitude.device)
    interior = (((rows > 0) & (rows < h - 1))[:, None]
                & ((cols > 0) & (cols < w - 1))[None, :])
    return torch.where(interior[..., None, None], slope, 0.0).to(TYPE_BOX)


# The neighbours whose difference XLA's CPU code for the env's terrain bundle
# rounds once from an unrounded product sum * 0.1 (see bundle_slope).
_CENTRE_FUSED = ((-1, 1), (0, -1), (0, 1))  # fl32(sum_c * 0.1 - alt_n)
_NEIGHBOUR_FUSED = (1, 0)  # fl32(alt_c - sum_n * 0.1)
_TAIL_FUSED = (-1, -1)  # centre-fused in the scalar remainder of its loop


def bundle_slope(alt_sum: torch.Tensor, altitude: torch.Tensor) -> torch.Tensor:
    """:func:`get_slope` of ``altitude = fl32(alt_sum * 0.1)`` as the
    Advanced env's jitted terrain bundle rounds it, (..., H, W) ->
    (..., H, W, 3, 3).

    Inside the bundle XLA does not read every altitude back: its slope
    fusion recomputes some as ``alt_sum * 0.1`` (``_altitude_field``'s
    ``/ 10``, folded), and LLVM contracts some of those products with the
    subtraction that follows into one fused multiply-subtract, so the
    difference is rounded once.  In jax 0.9.0's CPU code for x86 (the
    fusion is one loop nest per row of the 3x3 tensor, over columns in an
    8-lane body with a scalar remainder), with ``c = fl32(0.1)``:

    * (-1, +1), (0, -1), (0, +1): ``fl32(sum_c * c - alt_n)``;
    * (+1, 0): ``fl32(alt_c - sum_n * c)``;
    * (-1, -1): ``fl32(alt_c - alt_n)`` in the 8-lane body,
      ``fl32(sum_c * c - alt_n)`` in the scalar remainder: the columns from
      ``8 * (W // 8)`` when W >= 16, the whole row when W < 16;
    * (-1, 0), (+1, -1), (+1, +1): ``fl32(alt_c - alt_n)``, as
      :func:`get_slope`.

    Read from ``XLA_FLAGS=--xla_dump_to=DIR --xla_dump_hlo_as_text``: the
    concatenate fusion with eight ``atan2`` in
    ``*.jit__terrain_bundle.cpu_after_optimizations.txt``, its
    ``*.ir-with-opt.ll`` and ``objdump -d`` of its ``*.o`` (``vfmsub`` and
    ``vfnmadd`` where a difference is fused, ``vsub`` where not).  Another
    jax, or a CPU without FMA, may contract other products."""
    h, w = altitude.shape[-2:]
    lead = altitude.shape[:-2]

    def edge_pad(t):
        return torch.nn.functional.pad(t.reshape(-1, 1, h, w), (1, 1, 1, 1),
                                       mode="replicate").reshape(lead + (h + 2, w + 2))

    alt_p = edge_pad(altitude)
    prod_p = edge_pad(alt_sum.double()) * _RECIP_10  # sum * c, exact in float64
    prod_c = prod_p[..., 1:h + 1, 1:w + 1]
    tail = torch.arange(w, device=altitude.device) >= (8 * (w // 8) if w >= 16 else 0)
    out = []
    for di in (-1, 0, 1):
        row_entries = []
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                row_entries.append(torch.zeros_like(altitude))
                continue
            window = (..., slice(1 + di, 1 + di + h), slice(1 + dj, 1 + dj + w))
            alt_n = alt_p[window]
            if (di, dj) in _CENTRE_FUSED:
                diff = rng._fma_f32(prod_c, -alt_n)
            elif (di, dj) == _NEIGHBOUR_FUSED:
                diff = rng._fma_f32(-prod_p[window], altitude)
            elif (di, dj) == _TAIL_FUSED:
                diff = torch.where(tail, rng._fma_f32(prod_c, -alt_n), altitude - alt_n)
            else:
                diff = altitude - alt_n
            if di != 0 and dj != 0:
                diff = diff * _RECIP_1414  # / 1.414, folded as XLA folds it
            row_entries.append(torch.rad2deg(xla_atan(diff)))
        out.append(torch.stack(row_entries, dim=-1))
    slope = torch.stack(out, dim=-2)  # (..., H, W, 3, 3)
    rows = torch.arange(h, device=altitude.device)
    cols = torch.arange(w, device=altitude.device)
    interior = (((rows > 0) & (rows < h - 1))[:, None]
                & ((cols > 0) & (cols < w - 1))[None, :])
    return torch.where(interior[..., None, None], slope, 0.0).to(TYPE_BOX)


# 8 directional theta tables; theta = angle between the wind direction and
# the fire-propagation direction.
WIND_THETAS = np.array(
    [
        [[45, 0, 45], [90, 0, 90], [135, 180, 135]],  # North
        [[90, 45, 0], [135, 0, 45], [180, 135, 90]],  # Northeast
        [[135, 90, 45], [180, 0, 0], [135, 90, 45]],  # East
        [[180, 135, 90], [135, 0, 45], [90, 45, 0]],  # Southeast
        [[135, 180, 135], [90, 0, 90], [45, 0, 45]],  # South
        [[90, 135, 180], [45, 0, 135], [0, 45, 90]],  # Southwest
        [[45, 90, 135], [0, 0, 180], [45, 90, 135]],  # West
        [[0, 45, 90], [45, 0, 135], [90, 135, 180]],  # Northwest
    ],
    dtype=np.float64,
)


def calc_pw(theta):
    """Alexandridis wind factor, in float64 numpy: ``(wind, ft)``."""
    c_1, c_2 = 0.045, 0.131
    V = 10
    t = np.radians(theta)
    ft = np.exp(V * c_2 * (np.cos(t) - 1))
    return np.exp(c_1 * V) * ft, ft


def get_winds(use_hidden: bool = True, device=None):
    """The 8 ``(wind_matrix, ft)`` tables as (8, 3, 3) float32 tensors on
    ``device``.  The reference's ``use_hidden=False`` branch is dead: all 8
    directional matrices are returned regardless."""
    wind_matrices, fts = [], []
    for thetas in WIND_THETAS:
        wind_matrix, ft = calc_pw(np.asarray(thetas))
        wind_matrix[1, 1] = 0.0
        wind_matrices.append(wind_matrix)
        fts.append(ft)
    device = resolve_device(device)
    return (torch.tensor(np.stack(wind_matrices).astype(np.float32), device=device),
            torch.tensor(np.stack(fts).astype(np.float32), device=device))


def create_up_to_k_mappings(n: int, k: int, device=None):
    """Mappings between combination ids and binary selection vectors:
    ``(id_to_binary (ids, n) int32 tensor, binary_to_id dict)``."""
    binary_vectors = []
    binary_to_id = {}
    for i in range(k + 1):
        for combo in itertools.combinations(range(n), i):
            binary = [0] * n
            for idx in combo:
                binary[idx] = 1
            binary = tuple(binary)
            binary_to_id[binary] = len(binary_vectors)
            binary_vectors.append(binary)
    return (torch.tensor(binary_vectors, dtype=TYPE_INT, device=resolve_device(device)),
            binary_to_id)
