"""S4, four formulations of the dense windy-CA step: CUDA kernels, wrapper,
plain versions.

Counterpart of ``scripts/exp_ca_variants.py``'s bodies ``kernel_banded``,
``kernel_bool``, ``kernel_fma`` and ``kernel_swar``.  The kernels are
``gymca_torch/csrc/ca_variants.cu``, one ``__global__`` function per
formulation on K1's layout (a thread-block cluster of ``CLUSTER_BLOCKS``
row bands per env); its source note says what each computes.
Every formulation takes the inputs K1 takes for a CA env, without the shot
and the edit log: an (N, H, W) int8 grid of ``EMPTY, TREE, FIRE = 0, 3, 25``,
updated in place, and (N, 8) int32 weights, each 0 or ``PROPAGATION``, in
``NEIGHBOR_OFFSETS`` order.  Each returns ``(grid, counts)``, counts (N, 2)
int32 ``[trees, fires]`` of the new grid, and all equal
:func:`reference_step` (``windy_step_from_success``).

:func:`ca_variant_step` takes the formulation's plain version (``PLAIN``)
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gymca_torch import _build
from gymca_torch.ops.stencil import NEIGHBOR_OFFSETS, moore_shifts, shift
from gymca_torch.ops.windy import IDENTITY, windy_breaks, windy_step_from_success

__all__ = ["VARIANTS", "KERNEL_NAMES", "PLAIN", "EMPTY", "TREE", "FIRE", "CLUSTER_BLOCKS",
           "ca_variant_step", "reference_step", "bands", "shared_memory_bytes"]

EMPTY, TREE, FIRE = 0, 3, 25
VARIANTS = ("banded", "bool", "fma", "swar")
KERNEL_NAMES = {v: f"ca_{v}_kernel" for v in VARIANTS}  # as the profiler names them
_WIDX = {offset: i for i, offset in enumerate(NEIGHBOR_OFFSETS)}
_MAX_SHARED_BYTES = 232448 - 256  # a block's dynamic shared memory, less its static part
CLUSTER_BLOCKS = 4  # kCluster in the source: row bands (blocks) per env


def bands(h: int):
    """Each block's rows, as the kernel cuts an env of ``h`` rows: ``(r0, r1,
    rs, re)`` for block 0 .. ``CLUSTER_BLOCKS - 1``, owning rows ``[r0, r1)``
    (empty where ``r0 == r1``) and staging rows ``[rs, re)``, its band and a
    halo row each side inside the grid."""
    band = -(-h // CLUSTER_BLOCKS)
    out = []
    for b in range(CLUSTER_BLOCKS):
        r0 = min(b * band, h)
        r1 = min(r0 + band, h)
        out.append((r0, r1, max(r0 - 1, 0), min(r1 + 1, h)))
    return out


def shared_memory_bytes(h: int, w: int) -> int:
    """Dynamic shared memory of one kernel block: two stages of its band
    (``ceil(h / CLUSTER_BLOCKS)`` rows) and a halo row each side, rows padded
    to words."""
    return 2 * (-(-h // CLUSTER_BLOCKS) + 2) * 4 * ((w + 3) // 4)


def _counts(new):
    return torch.stack([(new == TREE).sum(dim=(1, 2)), (new == FIRE).sum(dim=(1, 2))],
                       dim=-1).to(torch.int32)


def _write(grid, new):
    grid.copy_(new.to(grid.dtype))
    return grid, _counts(grid)


def reference_step(grid, weights):
    """The step every formulation computes, from ``windy_step_from_success``;
    updates ``grid`` in place."""
    success = torch.zeros((grid.shape[0], 3, 3), dtype=torch.bool, device=grid.device)
    for i, (dr, dc) in enumerate(NEIGHBOR_OFFSETS):
        success[:, 1 - dr, 1 - dc] = weights[:, i] > 0
    return _write(grid, windy_step_from_success(grid, success, empty=EMPTY, tree=TREE,
                                                fire=FIRE))


def _decode(signal):
    b = windy_breaks(EMPTY, TREE, FIRE)
    return torch.where(signal >= b.consume, EMPTY,
                       torch.where(signal >= b.propagate, FIRE,
                                   torch.where(signal >= b.keep, TREE, EMPTY)))


def ca_banded_plain(grid, weights):
    """The int32 score ``2^11 g + sum_d w_d g[neighbour d]`` (0 outside the
    grid), decoded by ``windy_breaks``' thresholds."""
    g = grid.to(torch.int32)
    signal = IDENTITY * g
    for i, (_, view) in enumerate(moore_shifts(g, EMPTY)):
        signal = signal + weights[:, i, None, None] * view
    return _write(grid, _decode(signal))


def ca_fma_plain(grid, weights):
    """The banded score in float32, a multiply-add per direction (every
    value is an integer below 2^17, so no operation rounds)."""
    g = grid.to(torch.float32)
    signal = float(IDENTITY) * g
    for i, (_, view) in enumerate(moore_shifts(g, float(EMPTY))):
        signal = signal + weights[:, i, None, None].to(torch.float32) * view
    return _write(grid, _decode(signal))


def ca_bool_plain(grid, weights):
    """Fire masks (0 or -1 in int32) of the neighbours, each AND-ed with its
    direction's gate and OR-ed together; fire -> empty, tree -> fire where
    the OR is set."""
    g = grid.to(torch.int32)
    fire_mask = torch.where(g == FIRE, -1, 0).to(torch.int32)
    gate = -(weights > 0).to(torch.int32)  # 0 or -1 per direction
    acc = torch.zeros_like(fire_mask)
    for i, (_, view) in enumerate(moore_shifts(fire_mask, 0)):
        acc = acc | (view & gate[:, i, None, None])
    new = torch.where(fire_mask != 0, EMPTY, torch.where((g == TREE) & (acc != 0), FIRE, g))
    return _write(grid, new)


def _words(mask8):
    """(N, H, W) int8 bytes -> (N, H, W/4) uint32 words in int64, byte k of
    word c = column 4c + k."""
    return mask8.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _popcount(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _check_swar_width(w):
    if w % 4:
        raise ValueError(f"the swar formulation packs four cells per word and needs "
                         f"W % 4 == 0, got W = {w}")


def ca_swar_plain(grid, weights):
    """Four cells per uint32 word: fire masks 0xFF per byte, rows shifted
    whole, columns by a byte shift with the carry from the next word (zero
    at the edges); trees and fires counted by popcounts of packed bytes."""
    n, h, w = grid.shape
    _check_swar_width(w)
    gate = torch.where(weights > 0, 0xFFFFFFFF, 0).to(torch.int64)

    def gated(m, d):
        return m & gate[:, _WIDX[d], None, None]

    m = _words(torch.where(grid == FIRE, -1, 0).to(torch.int8))
    bu, bd = shift(m, 1, 0, 0), shift(m, -1, 0, 0)  # rows r + 1 and r - 1
    pre_p = gated(bu, (1, 1)) | gated(m, (0, 1)) | gated(bd, (-1, 1))
    pre_m = gated(bu, (1, -1)) | gated(m, (0, -1)) | gated(bd, (-1, -1))
    acc = gated(bu, (1, 0)) | gated(bd, (-1, 0))
    acc = acc | (pre_p >> 8) | ((shift(pre_p, 0, 1, 0) & 0xFF) << 24)  # from column + 1
    acc = acc | ((pre_m << 8) & 0xFFFFFFFF) | ((shift(pre_m, 0, -1, 0) >> 24) & 0xFF)

    burn8 = torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32).view(torch.int8)
    tree_old = grid == TREE
    burn = tree_old & (burn8 != 0)
    keep = tree_old & ~burn
    grid.copy_(torch.where(burn, FIRE, torch.where(keep, TREE, EMPTY)).to(grid.dtype))

    def count(mask):
        return _popcount(_words(mask.to(torch.int8))).sum(dim=(1, 2))

    return grid, torch.stack([count(keep), count(burn)], dim=-1).to(torch.int32)


PLAIN = {"banded": ca_banded_plain, "bool": ca_bool_plain, "fma": ca_fma_plain,
         "swar": ca_swar_plain}


@functools.cache
def _launcher():
    lib = _build.load("ca_variants")
    fn = lib.ca_variant_launch
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [c_int, ptr, ptr, ptr, c_int, c_int, c_int, ptr]
    fn.restype = c_int
    return fn


def ca_variant_step(variant: str, grid: torch.Tensor, weights: torch.Tensor):
    """One windy step of every env by formulation ``variant`` (one of
    ``VARIANTS``): returns ``(grid, counts)``, ``grid`` updated in place.

    CPU tensors take ``PLAIN[variant]``; CUDA tensors launch the kernel
    (``ca_variant_step.launches[variant]`` counts its launches).  The swar
    formulation needs W % 4 == 0; on the card two stages of a block's band
    must fit its shared memory (about 227 KiB: 512 x 512 grids fit)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    n, h, w = grid.shape
    dev = grid.device
    _build.check_operand("grid", grid, (n, h, w), torch.int8, dev)
    _build.check_operand("weights", weights, (n, 8), torch.int32, dev)
    if variant == "swar":
        _check_swar_width(w)
    if dev.type == "cpu":
        return PLAIN[variant](grid, weights)
    if dev.type != "cuda":
        raise ValueError(f"ca_variant_step runs on CPU or CUDA tensors, got {dev}")
    if shared_memory_bytes(h, w) > _MAX_SHARED_BYTES:
        raise ValueError(f"a {h}x{w} grid needs {shared_memory_bytes(h, w)} bytes of "
                         f"shared memory per block (two stages of its band), more than "
                         f"{_MAX_SHARED_BYTES}")
    counts = torch.empty((n, 2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _launcher()(VARIANTS.index(variant), grid.data_ptr(), weights.data_ptr(),
                          counts.data_ptr(), n, h, w,
                          torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ca_{variant} kernel launch failed: CUDA error {err}")
    if n:
        ca_variant_step.launches[variant] += 1
    return grid, counts


ca_variant_step.launches = dict.fromkeys(VARIANTS, 0)
