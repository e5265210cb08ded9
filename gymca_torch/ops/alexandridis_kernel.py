"""K2/K3, the fused Alexandridis step: CUDA kernel, wrapper, plain version.

Counterpart of ``gymca_tpu/ops/pallas_alexandridis.py::
alexandridis_fused_step``, both its single-program branch
(``_alexandridis_kernel``) and its row-band tiled branch
(``_alexandridis_tiled_kernel``).  The kernel is
``gymca_torch/csrc/alexandridis.cu``, one spatially tiled kernel for every
lattice size; its source note says what bounds it and how it is laid out.

The function is split in plain pieces:

* :func:`alexandridis_draws` — the two random words of every cell,
  threefry2x32 under the env's seed words with the flat cell index as the
  counter: a uniform ``u = (b1 >> 8) * 2**-24`` and the age bits ``b2``.
  They depend on (seed, cell) only, not on the kernel's tiling;
* :func:`alexandridis_ignition` — heat, dousing and the ignition threshold
  ``1 - prod_d max(1 - p_d * fire_d, 0)`` of every cell;
* :func:`alexandridis_rule` — the cell rule, given the draws.

``ablate`` names a phase to skip, the counterpart of the TPU kernel's
profiling aid (``scripts/bench_fused_ca.py``; outputs are wrong by
construction and the env never passes it): ``"boxes"`` takes heat = 8·fire
and dousing = the cell's dousing mask, ``"ignite"`` takes no_ignite =
max(1 − 0.1·base, 0), ``"prng"`` takes u = 0.5 and new ages =
``fire_age_min``.  The kernel has one compile-time instance per ablation;
the default instance is the step itself.

:func:`alexandridis_fused_step_plain` is the rule applied to the draws, with
every float operation in the kernel's order, so kernel and plain version
agree bit for bit.  :func:`alexandridis_fused_step` takes the plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from gymca_torch import _build, rng
from gymca_torch.ops.stencil import NEIGHBOR_OFFSETS, multi_box_sums, shift
from gymca_torch.utils.metrics import span

__all__ = ["alexandridis_fused_step", "alexandridis_fused_step_plain",
           "alexandridis_draws", "alexandridis_ignition", "alexandridis_rule",
           "alexandridis_work", "MAX_RADIUS", "ABLATIONS"]

MAX_RADIUS = 32  # kMaxRadius in the source
_MAX_ENVS = 65535  # the launch's grid z extent
_INV_2_24 = 2.0 ** -24
ABLATIONS = ("", "boxes", "ignite", "prng")  # index = the kernel's instance


def alexandridis_draws(seeds: torch.Tensor, h: int, w: int):
    """The draws of every cell: ``seeds`` (N, 2) key data (int64 words in
    [0, 2**32)) -> ``(u, age_bits)``, (N, H, W) float32 uniforms in [0, 1)
    and (N, H, W) int64 words in [0, 2**32)."""
    idx = torch.arange(h * w, dtype=torch.int64, device=seeds.device).reshape(h, w)
    k1 = seeds[:, 0, None, None]
    k2 = seeds[:, 1, None, None]
    b1, b2 = rng.threefry2x32(k1, k2, torch.zeros_like(idx), idx)
    return (b1 >> 8).to(torch.float32) * _INV_2_24, b2


def alexandridis_ignition(grid, dousing, vdf, exp_slope, wind_rows, *, fire: int,
                          layer_coeffs: Sequence[float], dousing_border: float,
                          dousing_inner: float, ablate: str = "") -> torch.Tensor:
    """The ignition threshold ``1 - prod_d max(1 - p_d * fire_d, 0)`` of every
    cell, (N, H, W) float32: a tree ignites where its uniform lies below it.
    Each float operation is one rounded float32 operation, in the kernel's
    order."""
    radii = list(range(1, len(layer_coeffs) + 1))
    fire_f = (grid == fire).to(torch.float32)
    if ablate == "boxes":
        heat = fire_f * 8.0
        dousing_ret = (dousing > 0).to(torch.float32)
    else:
        boxes = multi_box_sums(fire_f, radii)
        heat = torch.zeros_like(fire_f)
        for r, c in zip(radii, layer_coeffs):
            heat = heat + c * boxes[r]
        dbox = multi_box_sums((dousing > 0).to(torch.float32), (1, 2))
        dousing_ret = ((dousing_inner - dousing_border) * dbox[1]
                       + dousing_border * dbox[2])
    base = (heat - dousing_ret) * vdf.float()
    if ablate == "ignite":
        return 1.0 - torch.clamp(1.0 - base * 0.1, min=0.0)

    no_ignite = torch.ones_like(base)
    for d, (dr, dc) in enumerate(NEIGHBOR_OFFSETS):
        fire_there = shift(fire_f, dr, dc, 0.0)
        p = base * wind_rows[:, d, None, None] * exp_slope[:, 1 + dr, 1 + dc].float()
        no_ignite = no_ignite * torch.clamp(1.0 - p * fire_there, min=0.0)
    return 1.0 - no_ignite


def alexandridis_rule(grid, fire_age, dousing, vdf, exp_slope, wind_rows, u, age_bits,
                      *, empty: int, tree: int, fire: int,
                      layer_coeffs: Sequence[float], dousing_border: float,
                      dousing_inner: float, fire_age_min: int, fire_age_max: int,
                      ablate: str = ""):
    """One Alexandridis step per env given the draws ``u`` and ``age_bits``.

    ``grid``, ``dousing`` (N, H, W) int8; ``fire_age`` (N, H, W) float32;
    ``vdf`` (N, H, W) and ``exp_slope`` (N, 3, 3, H, W) bfloat16;
    ``wind_rows`` (N, 8) float32 in ``NEIGHBOR_OFFSETS`` order.  Returns
    ``(new_grid int8, new_age float32)``.
    """
    fire_mask = grid == fire
    ignite = u < alexandridis_ignition(
        grid, dousing, vdf, exp_slope, wind_rows, fire=fire, layer_coeffs=layer_coeffs,
        dousing_border=dousing_border, dousing_inner=dousing_inner, ablate=ablate)

    span = max(fire_age_max - fire_age_min, 1)
    sampled_age = (fire_age_min + age_bits % span).to(torch.float32)
    burnout = fire_mask & (fire_age <= 1.0)
    new_grid = torch.where((grid == tree) & ignite, fire,
                           torch.where(burnout, empty, grid.to(torch.int32)))
    new_fire = (new_grid == fire) & ~fire_mask
    new_age = torch.where(new_fire, sampled_age, fire_age)
    new_age = torch.where(fire_mask, new_age - 1.0, new_age)
    return new_grid.to(torch.int8), new_age


def alexandridis_fused_step_plain(grid, fire_age, dousing, vdf, exp_slope, wind_rows,
                                  seeds, *, ablate: str = "", **kw):
    """The kernel's function in plain torch: :func:`alexandridis_rule` on
    :func:`alexandridis_draws` (on u = 0.5 and age words 0 for ``ablate=
    "prng"``).  Same arguments as :func:`alexandridis_fused_step`."""
    h, w = grid.shape[-2:]
    if ablate == "prng":
        u = torch.full(grid.shape, 0.5, device=grid.device)
        age_bits = torch.zeros(grid.shape, dtype=torch.int64, device=grid.device)
    else:
        u, age_bits = alexandridis_draws(seeds, h, w)
    return alexandridis_rule(grid, fire_age, dousing, vdf, exp_slope, wind_rows, u,
                             age_bits, ablate=ablate, **kw)


def alexandridis_work(x: dict, kw: dict) -> dict:
    """Bytes the step must move and operations it must do on the inputs
    ``x`` (the keyword tensors of :func:`alexandridis_fused_step`; ``kw`` its
    other keywords), counted from the data, and the dense counts of a design
    that treats every cell as a candidate.

    A candidate is an on-grid tree with a burning Moore neighbour: only it
    can ignite.  Bytes: every cell reads grid (1) and age (4) and writes grid
    (1) and age (4); a cell within 2 of a candidate (the reach of its
    dousing box) reads dousing (1); a candidate reads vdf (2) and the
    exp_slope plane (2) of each burning neighbour; every env reads its wind
    row (32) and seeds (16).  Dense: 29 bytes per cell (dousing, vdf and the
    8 planes for every cell).  Integer operations: 4 per cell for the rule's compares
    and selects; per candidate 77 for threefry2x32 (2 key adds, then 5 x (4
    rounds of add, rotate, xor, and 3 key-schedule adds)), 3 per box sum of
    the R + 2 boxes and 4 for the uniform and the age.  Float32 operations:
    per candidate 2R for the heat, 3 for the dousing, 2 for the base and 2
    for the threshold; 5 per burning direction of a candidate; 1 per burning
    cell (its age).  Dense: the earlier count, every cell a candidate with 8
    directions and 4 integer operations for the tables."""
    grid = x["grid"]
    n, h, w = grid.shape
    r = len(kw["layer_coeffs"])
    fire = grid == kw["fire"]
    fire_i = fire.to(torch.int32)
    dirs = sum(shift(fire_i, dr, dc, 0) for dr, dc in NEIGHBOR_OFFSETS)
    cand = (grid == kw["tree"]) & (dirs > 0)
    cells = n * h * w
    n_cand = int(cand.sum())
    reach = torch.nn.functional.max_pool2d(cand[:, None].float(), 5, stride=1, padding=2)
    n_doused = int(reach.sum())
    n_dirs = int(torch.where(cand, dirs, 0).sum())
    n_burning = int(fire.sum())
    return dict(
        cells=cells, candidates=n_cand, candidate_directions=n_dirs, doused_cells=n_doused,
        bytes=cells * 10 + n_doused + 2 * n_cand + 2 * n_dirs + n * 48,
        int_ops=cells * 4 + n_cand * (77 + 3 * (r + 2) + 4),
        float_ops=n_cand * (2 * r + 7) + 5 * n_dirs + n_burning,
        dense_bytes=cells * 29 + n * 48,
        dense_int_ops=cells * (77 + 3 * (r + 2) + 4 + 4),
        dense_float_ops=cells * (2 * r + 3 + 2 + 5 * 8 + 2),
    )


@functools.cache
def _launcher():
    fn = _build.load("alexandridis").alexandridis_launch
    ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ptr] * 9 + [c_int, c_int, c_int, ctypes.POINTER(c_float), c_int,
                               c_float, c_float, c_int, c_int, c_int, c_int, c_int, c_int,
                               ptr]
    fn.restype = c_int
    return fn


@span("ca")
def alexandridis_fused_step(
    grid: torch.Tensor,  # (N, H, W) int8
    fire_age: torch.Tensor,  # (N, H, W) float32
    dousing: torch.Tensor,  # (N, H, W) int8
    vdf: torch.Tensor,  # (N, H, W) bfloat16 — (1+p_veg)(1+p_den)
    exp_slope: torch.Tensor,  # (N, 3, 3, H, W) bfloat16 — exp(0.078*slope)
    wind_rows: torch.Tensor,  # (N, 8) float32 — wind in NEIGHBOR_OFFSETS order
    seeds: torch.Tensor,  # (N, 2) int64 key data — the draws' seed words
    *,
    empty: int,
    tree: int,
    fire: int,
    layer_coeffs: Sequence[float],  # telescoped box coefficients, radius 1..R
    dousing_border: float,
    dousing_inner: float,
    fire_age_min: int,
    fire_age_max: int,
    ablate: str = "",  # profiling only: a phase to skip, one of ABLATIONS
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched fused Alexandridis step: returns ``(new_grid, new_fire_age)``,
    new tensors (int8 and float32).

    CPU tensors take :func:`alexandridis_fused_step_plain`; CUDA tensors
    launch the kernel (``alexandridis_fused_step.launches`` counts the
    launches).  The kernel has no alignment or size gate: any H, W and any
    radius up to ``MAX_RADIUS``.
    """
    n, h, w = grid.shape
    dev = grid.device
    kw = dict(empty=empty, tree=tree, fire=fire, layer_coeffs=tuple(layer_coeffs),
              dousing_border=dousing_border, dousing_inner=dousing_inner,
              fire_age_min=fire_age_min, fire_age_max=fire_age_max)
    _build.check_operand("grid", grid, (n, h, w), torch.int8, dev)
    _build.check_operand("fire_age", fire_age, (n, h, w), torch.float32, dev)
    _build.check_operand("dousing", dousing, (n, h, w), torch.int8, dev)
    _build.check_operand("vdf", vdf, (n, h, w), torch.bfloat16, dev)
    _build.check_operand("exp_slope", exp_slope, (n, 3, 3, h, w), torch.bfloat16, dev)
    _build.check_operand("wind_rows", wind_rows, (n, 8), torch.float32, dev)
    _build.check_operand("seeds", seeds, (n, 2), torch.int64, dev)
    if not 1 <= len(layer_coeffs) <= MAX_RADIUS:
        raise ValueError(f"need 1 to {MAX_RADIUS} heat coefficients, got "
                         f"{len(layer_coeffs)}")
    for v in (empty, tree, fire):
        if not -128 <= v <= 127:
            raise ValueError(f"cell value {v} does not fit int8")
    if ablate not in ABLATIONS:
        raise ValueError(f"ablate must be one of {ABLATIONS}, got {ablate!r}")

    if dev.type == "cpu":
        return alexandridis_fused_step_plain(grid, fire_age, dousing, vdf, exp_slope,
                                             wind_rows, seeds, ablate=ablate, **kw)
    if dev.type != "cuda":
        raise ValueError(f"alexandridis_fused_step runs on CPU or CUDA tensors, got {dev}")
    if n > _MAX_ENVS:
        raise ValueError(f"at most {_MAX_ENVS} envs per launch, got {n}")

    out_grid = torch.empty_like(grid)
    out_age = torch.empty_like(fire_age)
    # The seed words as uint32 bit patterns, in an int32 tensor.
    seeds32 = torch.where(seeds >= 2**31, seeds - 2**32, seeds).to(torch.int32)
    coeffs = (ctypes.c_float * len(layer_coeffs))(*layer_coeffs)
    span = max(fire_age_max - fire_age_min, 1)
    with torch.cuda.device(dev):
        err = _launcher()(
            grid.data_ptr(), fire_age.data_ptr(), dousing.data_ptr(), vdf.data_ptr(),
            exp_slope.data_ptr(), wind_rows.data_ptr(), seeds32.data_ptr(),
            out_grid.data_ptr(), out_age.data_ptr(), n, h, w, coeffs, len(layer_coeffs),
            float(np.float32(dousing_inner - dousing_border)),
            float(np.float32(dousing_border)), empty, tree, fire, fire_age_min, span,
            ABLATIONS.index(ablate), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"alexandridis kernel launch failed: CUDA error {err}")
    if n:
        alexandridis_fused_step.launches += 1
    return out_grid, out_age


alexandridis_fused_step.launches = 0
