"""S1, S2, S3 and S5, the launch-floor family: CUDA kernel, wrapper, plain
version.

Counterpart of the no-op TPU kernels of ``scripts/exp_counts_out.py``,
``scripts/exp_launch_floor.py``, ``scripts/exp_kernel_overhead.py`` and
``scripts/exp_floor.py``.  The kernel is ``gymca_torch/csrc/probe_floor.cu``:
one kernel for the family, told at run time how many envs a block walks,
how wide each env's parameter row is (``table_w``, 0, 1, 8 or 16 int32) and
how its counts are written (``counts_w``, 0, 1 or 4 int32; ``staged``: built
in shared memory and written with one bulk copy per block).  The (N, H, W)
grid is passed and never touched, the counterpart of ``pl.ANY`` with
aliasing.  Counts are ``[p[e, 4], p[e, 5], 0, 0]`` where ``table_w >= 6``,
else ``[1, 0, 0, 0]``, cut to ``counts_w``.  On the TPU only each program's
first count slot was written and the rest of the output was whatever was
there; here every slot is written, a defined superset.

``exp_launch_floor.py``'s ``run_partition`` has no counterpart: it times the
XLA class partition of K1's wrapper, which the port does not do (K1 launches
one block per env and idle blocks exit), and its cost on the card is K1's
idle floor.  S2's and S5's per-program bounds rows, an SMEM block the TPU
body never read, are not read either.

:func:`probe_floor` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence

import torch

from gymca_torch import _build
from gymca_torch.config import resolve_device
from gymca_torch.probes import timing

__all__ = ["probe_floor", "probe_floor_plain", "moved_bytes", "TABLE_WIDTHS",
           "COUNT_WIDTHS", "FloorVariant", "variant_tables", "run_variants", "main",
           "one_sm_copy"]

TABLE_WIDTHS = (0, 1, 8, 16)
COUNT_WIDTHS = (0, 1, 4)
_MAX_SHARED_BYTES = 232448


def moved_bytes(n: int, table_w: int, counts_w: int) -> int:
    """Bytes one launch must move: every env's table row read and counts
    written."""
    return n * 4 * (table_w + counts_w)


def probe_floor_plain(n: int, table: Optional[torch.Tensor], *, counts_w: int,
                      device=None) -> Optional[torch.Tensor]:
    """The counts the kernel writes for ``n`` envs: (n, counts_w) int32, or
    None when ``counts_w`` is 0."""
    if counts_w == 0:
        return None
    dev = table.device if table is not None else device
    counts = torch.zeros((n, 4), dtype=torch.int32, device=dev)
    if table is not None and table.shape[1] >= 6:
        counts[:, :2] = table[:, 4:6]
    else:
        counts[:, 0] = 1
    return counts[:, :counts_w].contiguous()


@functools.cache
def _launcher():
    fn = _build.load("probe_floor").probe_floor_launch
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, c_int, c_int, c_int, c_int, c_int, ptr]
    fn.restype = c_int
    return fn


def probe_floor(grid: Optional[torch.Tensor], table: Optional[torch.Tensor], *,
                counts_w: int, envs_per_block: int, staged: bool = False
                ) -> Optional[torch.Tensor]:
    """One launch over N envs: ``grid`` (N, H, W) int8, never touched, or
    None for the form without a grid; ``table`` (N, table_w) int32 or None;
    returns the (N, counts_w) int32 counts, or None when ``counts_w`` is 0.
    N is the grid's first dimension, else the table's.

    CPU tensors take :func:`probe_floor_plain`; CUDA tensors launch the
    kernel (``probe_floor.launches`` counts the launches).  ``staged``
    needs ``envs_per_block * counts_w`` and ``N * counts_w`` to be multiples
    of 4 (the bulk copy moves 16-byte units)."""
    if grid is None and table is None:
        raise ValueError("probe_floor needs a grid or a table to know N")
    ref = grid if grid is not None else table
    n, dev = ref.shape[0], ref.device
    if grid is not None:
        _build.check_operand("grid", grid, grid.shape, torch.int8, dev)
    table_w = 0 if table is None else table.shape[-1]
    if table is not None:
        if table_w not in TABLE_WIDTHS[1:]:
            raise ValueError(f"table_w must be one of {TABLE_WIDTHS[1:]}, got {table_w}")
        _build.check_operand("table", table, (n, table_w), torch.int32, dev)
        if table.data_ptr() % 16:
            raise ValueError("the table must be 16-byte aligned")
    if counts_w not in COUNT_WIDTHS:
        raise ValueError(f"counts_w must be one of {COUNT_WIDTHS}, got {counts_w}")
    if envs_per_block < 1:
        raise ValueError(f"envs_per_block must be positive, got {envs_per_block}")
    if staged and ((envs_per_block * counts_w) % 4 or (n * counts_w) % 4):
        raise ValueError("the staged form writes 16-byte units: envs_per_block * counts_w "
                         f"and N * counts_w must be multiples of 4, got {envs_per_block}, "
                         f"{n} and {counts_w}")
    if dev.type == "cpu":
        return probe_floor_plain(n, table, counts_w=counts_w, device=dev)
    if dev.type != "cuda":
        raise ValueError(f"probe_floor runs on CPU or CUDA tensors, got {dev}")
    if staged and envs_per_block * counts_w * 4 > _MAX_SHARED_BYTES:
        raise ValueError(f"{envs_per_block} envs of {counts_w} counts pass a block's "
                         "shared memory")
    counts = (torch.empty((n, counts_w), dtype=torch.int32, device=dev) if counts_w
              else None)
    with torch.cuda.device(dev):
        err = _launcher()(
            None if grid is None else grid.data_ptr(),
            None if table is None else table.data_ptr(),
            None if counts is None else counts.data_ptr(),
            n, envs_per_block, table_w, counts_w, int(staged),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_floor kernel launch failed: CUDA error {err}")
    if n:
        probe_floor.launches += 1
    return counts


probe_floor.launches = 0


@functools.cache
def _copy_launcher():
    fn = _build.load("probe_floor").one_sm_copy_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def one_sm_copy(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``dst.copy_(src)`` by one block of the card, a thread driving the
    bulk-copy engine: the yardstick of the rate one SM reaches, for S3's
    bound where one block walks 4096 envs.  ``src`` and ``dst`` are 1-D int8
    of one length, a multiple of 16, and 16-byte aligned.  CPU tensors take
    ``dst.copy_(src)``; CUDA tensors launch the kernel or raise."""
    dev = src.device
    _build.check_operand("src", src, src.shape, torch.int8, dev)
    _build.check_operand("dst", dst, src.shape, torch.int8, dev)
    if src.dim() != 1 or src.numel() % 16 or src.data_ptr() % 16 or dst.data_ptr() % 16:
        raise ValueError("one_sm_copy takes 1-D int8 tensors of a multiple of 16 bytes, "
                         "16-byte aligned")
    if dev.type == "cpu":
        return dst.copy_(src)
    if dev.type != "cuda":
        raise ValueError(f"one_sm_copy runs on CPU or CUDA tensors, got {dev}")
    with torch.cuda.device(dev):
        err = _copy_launcher()(src.data_ptr(), dst.data_ptr(), src.numel(),
                               torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"one_sm_copy kernel launch failed: CUDA error {err}")
    return dst


# --- the entry points' sweep ------------------------------------------------------------


class FloorVariant(NamedTuple):
    """One launch configuration of a floor probe."""
    label: str
    n: int
    envs_per_block: int
    table_w: int
    counts_w: int
    staged: bool = False
    grid: bool = True  # False: the form without a grid


def variant_tables(variants: Sequence[FloorVariant], device) -> List[Optional[torch.Tensor]]:
    """Each variant's parameter table as :func:`run_variants` draws it: (n,
    table_w) int32 from one generator seeded 0, in order, or None."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return [torch.randint(-2**31, 2**31 - 1, (v.n, v.table_w), generator=gen, device=device,
                          dtype=torch.int32) if v.table_w else None for v in variants]


def run_variants(variants: Sequence[FloorVariant], steps: int, device=None, reps: int = 3,
                 h: int = 256, w: int = 256) -> List[dict]:
    """For each variant: check the launch's counts against the plain version
    on its table from :func:`variant_tables` (the row's ``max_abs_err``,
    which is 0: a difference raises), then (on the card) time ``steps``
    launches in ``reps`` repetitions (``timing.time_launches``).  The grids
    are (N, h, w) int8 zeros, never touched.  Returns one row per variant
    (times None on the CPU)."""
    dev = resolve_device(device)
    n_max = max(v.n for v in variants)
    grid = torch.zeros((n_max, h, w), dtype=torch.int8, device=dev)
    rows = []
    for v, table in zip(variants, variant_tables(variants, dev)):
        g = grid[:v.n] if v.grid else None

        def call(v=v, g=g, table=table):
            return probe_floor(g, table, counts_w=v.counts_w,
                               envs_per_block=v.envs_per_block, staged=v.staged)

        got, want = call(), probe_floor_plain(v.n, table, counts_w=v.counts_w, device=dev)
        if (got is None) != (want is None) or (got is not None and got.shape != want.shape):
            raise RuntimeError(f"probe_floor's counts differ in shape from its plain version: "
                               f"{v.label}")
        err = 0 if got is None or not got.numel() else int(
            (got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err:
            raise RuntimeError(f"probe_floor differs from its plain version by {err}: {v.label}")
        row = {**v._asdict(), "max_abs_err": err, "device_us": None, "host_us": None,
               "bytes": moved_bytes(v.n, v.table_w, v.counts_w)}
        if dev.type == "cuda":
            row.update(timing.time_launches(lambda call=call: [call() for _ in range(steps)],
                                            steps, "probe_floor_kernel", reps))
        rows.append(row)
    return rows


def main(variants: Sequence[FloorVariant], steps: int, argv=None, description=None):
    """The floor probes' command line: time ``variants`` on the card and
    print a line for each."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--steps", type=int, default=steps)
    a = ap.parse_args(argv)
    dev = resolve_device()
    print(f"[device] {timing.card()}", flush=True)
    for r in run_variants(variants, a.steps, dev):
        print(f"{r['label']:36s}: {r['device_us']:7.2f} us/launch device, "
              f"{r['host_us']:7.2f} us/launch host (N={r['n']}, {r['envs_per_block']} envs/block, "
              f"table {r['table_w']}, counts {r['counts_w']}"
              f"{', staged' if r['staged'] else ''}{'' if r['grid'] else ', no grid'}; "
              f"{a.steps} launches, 3 repetitions)", flush=True)
