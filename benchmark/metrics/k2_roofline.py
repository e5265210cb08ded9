"""K2's share of its roofline over the profiled steps, in %.

K2 is the Advanced env's fused Alexandridis kernel (``alexandridis_kernel``,
one launch a step).  Its least time for a step's inputs is the larger of
the bytes at the H100 SXM's 3.35 TB/s and the operations at 16.75 T int32
ops/s or 67 TFLOP/s float32, whichever is slower (NVIDIA data-sheet rates
at the full 700 W; the result line gives the card's limit).  Counted from
the grid and the dousing marks the step starts from: every cell reads grid
(1 B) and age (4 B) and writes both; a candidate (a tree with a burning
Moore neighbour, the only cell that can ignite) reads its vegetation-density
factor (2 B) and the slope plane of each burning neighbour (2 B); a cell
within 2 of a candidate reads its dousing mark (1 B); every env reads its
wind row and seed (48 B).  Integer operations: 4 a cell for the rule, per
candidate 77 for its threefry hash, 3 for each of the R + 2 box sums and 4
for the uniform and the age; float: per candidate 2R + 7, 5 per burning
direction, 1 per burning cell.  R is the heat kernel's radius.  The device
time is the kernel's mean event times the profiled steps.  A frozen copy of
the port's ``alexandridis_work``.
"""

import math

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.75e12
FP32_OPS_PER_S = 67e12
KERNELS = ("alexandridis_kernel",)


def work(cfg: dict, grid) -> tuple:
    """(bytes, int32 operations, float32 operations) of one step on ``grid``
    (N, H, W) int8."""
    n, h, w = grid.shape
    r = max(math.ceil(math.log2(max(cfg["nrows"], 4))) - 2, 1)
    fire = grid == cfg["cells"]["fire"]
    padded = F.pad(fire.to(torch.int32), (1, 1, 1, 1))
    dirs = sum(padded[:, 1 + dr:1 + dr + h, 1 + dc:1 + dc + w]
               for dr in (-1, 0, 1) for dc in (-1, 0, 1) if (dr, dc) != (0, 0))
    cand = (grid == cfg["cells"]["tree"]) & (dirs > 0)
    cells = n * h * w
    n_cand = int(cand.sum())
    n_doused = int(F.max_pool2d(cand[:, None].float(), 5, stride=1, padding=2).sum())
    n_dirs = int(torch.where(cand, dirs, 0).sum())
    moved = cells * 10 + n_doused + 2 * n_cand + 2 * n_dirs + n * 48
    int_ops = cells * 4 + n_cand * (77 + 3 * (r + 2) + 4)
    float_ops = n_cand * (2 * r + 7) + 5 * n_dirs + int(fire.sum())
    return moved, int_ops, float_ops


def read(run):
    trace, traced = run["trace"], run["traced"]
    if trace is None or not traced:
        return None
    seconds = trace.kernel_seconds(KERNELS, len(traced))
    if not seconds:
        return None
    least = 0.0
    for x, _ in traced:
        moved, int_ops, float_ops = work(run["config"], x["grid"])
        least += max(moved / HBM_BYTES_PER_S, int_ops / INT32_OPS_PER_S,
                     float_ops / FP32_OPS_PER_S)
    return 100.0 * least / seconds
