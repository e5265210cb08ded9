"""S6, the streaming floor of the Alexandridis step: CUDA kernel, wrapper,
plain version.

Counterpart of ``scripts/bench_fused_ca.py::dma_floor``.  The kernel is
``gymca_torch/csrc/dma_floor.cu``: it moves exactly the bytes the port's
Alexandridis kernel must move (29 per cell and 48 per env, as
``alexandridis_kernel.alexandridis_work`` counts them) and computes
``out_grid = grid`` and ``out_age = age + 1``.  What it reads besides is
folded into one int32 word per env, the XOR of every 32-bit word of
``dousing``, ``vdf``, the 8 direction planes of ``exp_slope``, ``wind_rows``
and ``seeds`` of that env, so that no load is dropped as dead; the plain
version computes the same word.

:func:`dma_floor` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gymca_torch import _build

__all__ = ["dma_floor", "dma_floor_plain", "moved_bytes"]

_CENTRE_PLANE = 4  # exp_slope[:, 1, 1]: no input of the Alexandridis step
_MAX_ENVS = 65535  # the launch's grid y extent


def moved_bytes(n: int, h: int, w: int) -> int:
    """Bytes one launch moves: grid 1, age 4, dousing 1, vdf 2 and eight
    slope planes 16 read, grid 1 and age 4 written, per cell; wind 32 and
    seeds 16 per env."""
    return n * h * w * 29 + n * (32 + 16)


def _xor_words(x: torch.Tensor) -> torch.Tensor:
    """(N, ...) -> (N,) int32: the XOR of each env's 32-bit words."""
    words = x.contiguous().view(x.shape[0], -1).view(torch.int32)
    while words.shape[1] > 1:
        if words.shape[1] % 2:
            words = torch.cat([words, torch.zeros_like(words[:, :1])], dim=1)
        words = words[:, 0::2] ^ words[:, 1::2]
    return words[:, 0]


def dma_floor_plain(grid, fire_age, dousing, vdf, exp_slope, wind_rows, seeds):
    """``(grid.clone(), fire_age + 1, fold)``, fold the per-env XOR word."""
    n = grid.shape[0]
    planes = [k for k in range(9) if k != _CENTRE_PLANE]
    slope = exp_slope.reshape(n, 9, -1)[:, planes]
    fold = (_xor_words(dousing) ^ _xor_words(vdf.view(torch.int16)) ^
            _xor_words(slope.view(torch.int16)) ^ _xor_words(wind_rows) ^ _xor_words(seeds))
    return grid.clone(), fire_age + 1.0, fold


@functools.cache
def _launcher():
    fn = _build.load("dma_floor").dma_floor_launch
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 10 + [c_int, c_int, c_int, ptr]
    fn.restype = c_int
    return fn


def dma_floor(
    grid: torch.Tensor,  # (N, H, W) int8
    fire_age: torch.Tensor,  # (N, H, W) float32
    dousing: torch.Tensor,  # (N, H, W) int8
    vdf: torch.Tensor,  # (N, H, W) bfloat16
    exp_slope: torch.Tensor,  # (N, 3, 3, H, W) bfloat16
    wind_rows: torch.Tensor,  # (N, 8) float32
    seeds: torch.Tensor,  # (N, 2) int64
):
    """Stream the Alexandridis step's inputs: returns ``(out_grid, out_age,
    fold)``, new tensors: ``grid``'s copy, ``fire_age + 1`` and the (N,)
    int32 XOR word of the other inputs.  Same arguments as
    ``alexandridis_fused_step``; H * W must be a multiple of 16.

    CPU tensors take :func:`dma_floor_plain`; CUDA tensors launch the kernel
    (``dma_floor.launches`` counts the launches)."""
    n, h, w = grid.shape
    dev = grid.device
    for name, t, shape, dtype in (
            ("grid", grid, (n, h, w), torch.int8),
            ("fire_age", fire_age, (n, h, w), torch.float32),
            ("dousing", dousing, (n, h, w), torch.int8),
            ("vdf", vdf, (n, h, w), torch.bfloat16),
            ("exp_slope", exp_slope, (n, 3, 3, h, w), torch.bfloat16),
            ("wind_rows", wind_rows, (n, 8), torch.float32),
            ("seeds", seeds, (n, 2), torch.int64)):
        _build.check_operand(name, t, shape, dtype, dev)
    if (h * w) % 16:
        raise ValueError(f"the probe streams 16-cell vectors and needs H * W % 16 == 0, "
                         f"got {h}x{w}")
    if dev.type == "cpu":
        return dma_floor_plain(grid, fire_age, dousing, vdf, exp_slope, wind_rows, seeds)
    if dev.type != "cuda":
        raise ValueError(f"dma_floor runs on CPU or CUDA tensors, got {dev}")
    if n > _MAX_ENVS:
        raise ValueError(f"at most {_MAX_ENVS} envs per launch, got {n}")
    ins = (grid, fire_age, dousing, vdf, exp_slope, wind_rows, seeds)
    if any(t.data_ptr() % 16 for t in ins):
        raise ValueError("the probe's inputs must be 16-byte aligned")
    out_grid, out_age = torch.empty_like(grid), torch.empty_like(fire_age)
    fold = torch.zeros((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _launcher()(*(t.data_ptr() for t in ins), out_grid.data_ptr(),
                          out_age.data_ptr(), fold.data_ptr(), n, h, w,
                          torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dma_floor kernel launch failed: CUDA error {err}")
    if n:
        dma_floor.launches += 1
    return out_grid, out_age, fold


dma_floor.launches = 0
