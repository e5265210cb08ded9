"""K1, the sparse windy-Bulldozer step: CUDA kernel, wrapper, plain version.

Counterpart of ``gymca_tpu/ops/pallas_kernels.py``: ``windy_fused_step``
(the TPU kernel ``_windy_sparse_kernel``) and ``windy_weights_from_roll``.
The kernel is ``gymca_torch/csrc/windy_sparse.cu``; its source note says
what bounds it and how it is laid out.

:func:`windy_fused_step` takes the plain version,
:func:`windy_fused_step_plain`, only for tensors on the CPU.  For CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from gymca_torch import _build
from gymca_torch.ops.stencil import NEIGHBOR_OFFSETS
from gymca_torch.ops.windy import (
    PROPAGATION,
    assert_windy_encoding,
    windy_step_from_success,
)
from gymca_torch.utils.metrics import span

__all__ = ["windy_fused_step", "windy_fused_step_plain", "windy_weights_from_roll",
           "shared_memory_bytes", "CLUSTER_BLOCKS"]

# The most dynamic shared memory an H100 block may use.
_MAX_SHARED_BYTES = 232448
CLUSTER_BLOCKS = 4  # kCluster in the source: row bands (blocks) per CA env


def windy_weights_from_roll(wind: torch.Tensor, roll: torch.Tensor) -> torch.Tensor:
    """Per-update direction weights, one int32 per Moore offset.

    ``wind`` (3, 3) propagation probabilities; ``roll`` (..., 3, 3) uniform
    sample.  Offset ``(dr, dc)`` is gated by ``wind[1-dr, 1-dc] > roll``.
    Returns (..., 8) int32: PROPAGATION where the gust succeeded else 0, in
    ``NEIGHBOR_OFFSETS`` order.
    """
    success = wind > roll
    return torch.stack(
        [torch.where(success[..., 1 - dr, 1 - dc], PROPAGATION, 0)
         for dr, dc in NEIGHBOR_OFFSETS],
        dim=-1,
    ).to(torch.int32)


def shared_memory_bytes(h: int, w: int) -> int:
    """Shared memory of one CA-pass block: tree and fire bit masks of its row
    band (``ceil(h / CLUSTER_BLOCKS)`` rows) and a halo row each side."""
    return 2 * 4 * (-(-h // CLUSTER_BLOCKS) + 2) * ((w + 31) // 32)


_scratch: dict = {}


def _scratch_for(n: int, device: torch.device, stream: int) -> torch.Tensor:
    """The kernel's device scratch for ``n`` envs on one stream: a counter of
    CA envs, a counter of finished clusters and ``n`` list slots, zero
    between calls (each call leaves it as it found it).  Made once per
    (device, stream, n), so a step adds no torch op for it."""
    key = (device, stream, n)
    buf = _scratch.get(key)
    if buf is None:
        buf = _scratch[key] = torch.zeros(n + 2, dtype=torch.int32, device=device)
    return buf


def windy_fused_step_plain(grid, weights, params, edits, edit_counts, *,
                           empty: int, tree: int, fire: int):
    """The kernel's function in plain torch, updating ``grid`` in place.

    Same contract as :func:`windy_fused_step`: replay, then
    ``windy_step_from_success``, then the shot, then the counts, for CA envs;
    the single-cell modify for modify-only envs; nothing for the rest.
    """
    n, h, w = grid.shape
    dev = grid.device
    do_ca = params[:, 0] > 0
    shoot = params[:, 3] > 0
    rc = (params[:, 1].long() * w + params[:, 2].long())[:, None]

    g = grid.to(torch.int32)
    k = edits.shape[1]
    if k:
        r, c = edits & 0xFFFF, edits >> 16
        valid = ((torch.arange(k, device=dev) < edit_counts[:, None])
                 & do_ca[:, None] & (r < h) & (c >= 0) & (c < w))
        flat = torch.where(valid, r * w + c, 0).long()
        edited = torch.zeros((n, h * w), dtype=torch.int32, device=dev)
        edited.scatter_add_(1, flat, valid.to(torch.int32))
        g = torch.where(edited.view(n, h, w) > 0, empty, g)

    success = torch.zeros((n, 3, 3), dtype=torch.bool, device=dev)
    for i, (dr, dc) in enumerate(NEIGHBOR_OFFSETS):
        success[:, 1 - dr, 1 - dc] = weights[:, i] > 0
    new = windy_step_from_success(g, success, empty=empty, tree=tree, fire=fire)

    new_flat = new.view(n, h * w)
    at = new_flat.gather(1, rc)[:, 0]
    hit_ca = do_ca & shoot & (at == tree)
    new_flat.scatter_(1, rc, torch.where(hit_ca, empty, at)[:, None])

    out = torch.where(do_ca[:, None, None], new.to(grid.dtype), grid)
    out_flat = out.view(n, h * w)
    cur = out_flat.gather(1, rc)[:, 0]
    hit_mod = ~do_ca & shoot & (cur == tree)
    out_flat.scatter_(1, rc, torch.where(hit_mod, empty, cur).to(grid.dtype)[:, None])
    grid.copy_(out)

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    counts = torch.stack([
        torch.where(do_ca, (new == tree).sum(dim=(1, 2)), zero),
        torch.where(do_ca, (new == fire).sum(dim=(1, 2)), zero),
        (hit_ca | hit_mod).to(torch.int64),
    ], dim=-1).to(torch.int32)
    return grid, counts


@functools.cache
def _launcher():
    fn = _build.load("windy_sparse").windy_sparse_launch
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, c_int, ptr, ptr, ptr, ptr, ptr, ptr,
                   c_int, c_int, c_int, c_int, c_int, c_int, c_int, ptr]
    fn.restype = c_int
    return fn


@span("ca")
def windy_fused_step(
    grid: torch.Tensor,  # (N, H, W) int8 or int32, updated in place
    weights: torch.Tensor,  # (N, 8) int32 — windy_weights_from_roll output
    params: torch.Tensor,  # (N, 4) int32 — [do_ca, row, col, shoot]
    edits: torch.Tensor | None = None,  # (N, K) int32 — row | col<<16 words
    edit_counts: torch.Tensor | None = None,  # (N,) int32 — valid prefix len
    *,
    empty: int,
    tree: int,
    fire: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse fused windy-CA + Modify + counts step over a batch of envs.

    Returns ``(grid, counts)``: ``grid`` is the input tensor, updated in
    place; ``counts`` is (N, 3) int32 ``[tree, fire, hit]`` of the new grid
    for CA envs (``do_ca``), ``[0, 0, hit]`` for modify-only envs
    (``shoot`` without ``do_ca``) and zeros for the rest, whose grids are not
    touched.  For each CA env, ``edits[e, :edit_counts[e]]`` (deferred Modify
    writes, each turning a cell ``empty``) are replayed before the stencil.
    Grids hold only ``{empty, tree, fire}``; ``row, col`` lie on the grid.

    CPU tensors take :func:`windy_fused_step_plain`; CUDA tensors launch
    the kernel (``windy_fused_step.launches`` counts the calls; each issues
    two device kernels, the light pass and the CA pass).
    """
    n, h, w = grid.shape
    dev = grid.device
    if edits is None:
        edits = torch.zeros((n, 0), dtype=torch.int32, device=dev)
        edit_counts = torch.zeros((n,), dtype=torch.int32, device=dev)
    if grid.dtype not in (torch.int8, torch.int32):
        raise ValueError(f"grid must be int8 or int32, got {grid.dtype}")
    if not grid.is_contiguous():
        raise ValueError("grid must be contiguous")
    _build.check_operand("weights", weights, (n, 8), torch.int32, dev)
    _build.check_operand("params", params, (n, 4), torch.int32, dev)
    _build.check_operand("edits", edits, (n, edits.shape[-1]), torch.int32, dev)
    _build.check_operand("edit_counts", edit_counts, (n,), torch.int32, dev)
    assert_windy_encoding(empty, tree, fire)
    info = torch.iinfo(grid.dtype)
    if not info.min <= empty < tree < fire <= info.max:
        raise ValueError(f"cell values {empty, tree, fire} do not fit {grid.dtype}")
    if h > 0xFFFF or w > 0x7FFF:
        raise ValueError("edit words (row | col << 16) need rows below 2**16 "
                         "and columns below 2**15")

    if dev.type == "cpu":
        return windy_fused_step_plain(grid, weights, params, edits, edit_counts,
                                      empty=empty, tree=tree, fire=fire)
    if dev.type != "cuda":
        raise ValueError(f"windy_fused_step runs on CPU or CUDA tensors, got {dev}")
    smem = shared_memory_bytes(h, w)
    if smem > _MAX_SHARED_BYTES:
        raise ValueError(
            f"a {h}x{w} grid needs {smem} bytes of shared memory per block, "
            f"more than the {_MAX_SHARED_BYTES} a block may use")

    counts = torch.empty((n, 3), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = _scratch_for(n, dev, stream)
        err = _launcher()(
            grid.data_ptr(), grid.element_size(), weights.data_ptr(),
            params.data_ptr(), edits.data_ptr(), edit_counts.data_ptr(),
            counts.data_ptr(), scratch.data_ptr(), n, h, w, edits.shape[1], empty, tree,
            fire, stream,
        )
    if err != 0:
        _scratch.pop((dev, stream, n), None)  # a pass may not have run: not zero
        raise RuntimeError(f"windy_sparse kernel launch failed: CUDA error {err}")
    if n:
        windy_fused_step.launches += 1
    return grid, counts


windy_fused_step.launches = 0
