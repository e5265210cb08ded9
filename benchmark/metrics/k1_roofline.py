"""K1's share of its roofline over the profiled steps, in %.

K1 is the windy Bulldozer's fused kernel (``windy_light_kernel`` and
``windy_band_kernel``, one launch of each a step).  Its least time for a
step's inputs is the larger of the bytes those inputs need at the H100 SXM's
3.35 TB/s of HBM3 and the integer operations at 16.75 T int32 ops/s (the
67 TFLOP/s float32 peak over its FMA's two operations and Hopper's 64 int32
lanes against 128 float32 lanes an SM), both NVIDIA data-sheet rates at the
full 700 W (the result line gives the card's limit).  The bytes: every env's
params read (16 B) and counts written (12 B); an env that applies the CA
this step reads its weights (32 B), its edit count (4 B) and each replayed
edit word (4 B), and reads and writes its grid once; an env whose shot
overflows its edit log reads and writes one cell.  Operations: 4 + 40/32
a cell of a CA env (classify, write back, the word-parallel stencil).  The
classes come from the states and actions the benchmark holds, with the
env's float32 time arithmetic; overflow is counted for every env that shoots
with a full log (an upper bound of a few bytes; it does not happen at this
log length).  The device time is each kernel's mean event times the
profiled steps.  A frozen copy of the port's ``k1_work``.
"""

import math

import torch

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.75e12
OPS_PER_CELL = 4 + 40 / 32
KERNELS = ("windy_light_kernel", "windy_band_kernel")


def work(cfg: dict, x: dict, actions) -> tuple:
    """(bytes, int32 operations) K1 needs for one step from state ``x``
    (``time``, ``done``, ``edit_count``) under ``actions`` (N, 2)."""
    h, w = cfg["nrows"], cfg["ncols"]
    dev = actions.device
    scale = (h + w) // 2
    t_any = cfg["t_any"]
    t_move = 1 / (cfg["speed_move"] * scale) - t_any
    t_shoot = 1 / (cfg["speed_act"] * scale) - t_move
    move = [t_move] * 9
    move[4] = 0.0
    move = torch.tensor(move, dtype=torch.float32, device=dev)
    shoot = torch.tensor([0.0, t_shoot], dtype=torch.float32, device=dev)
    taken = (move[actions[:, 0].long()] + shoot[actions[:, 1].long()]
             + torch.tensor(t_any, dtype=torch.float32, device=dev))
    live = ~x["done"]
    ca = (torch.trunc(x["time"] + taken) >= 1) & live
    k = min(math.floor(1.0 / (t_shoot + t_any)) + 1, 64)
    n = actions.shape[0]
    n_ca = int(ca.sum())
    n_mod = int((~ca & live & (actions[:, 1] > 0) & (x["edit_count"] >= k)).sum())
    n_edits = int(x["edit_count"].clamp(0, k)[ca].sum())
    item = torch.tensor([], dtype=getattr(torch, cfg["grid_dtype"])).element_size()
    moved = n * (16 + 12) + n_ca * (32 + 4 + 2 * h * w * item) + 4 * n_edits + n_mod * 2 * item
    return moved, n_ca * h * w * OPS_PER_CELL


def read(run):
    trace, traced = run["trace"], run["traced"]
    if trace is None or not traced:
        return None
    seconds = trace.kernel_seconds(KERNELS, len(traced))
    if not seconds:
        return None
    least = 0.0
    for x, actions in traced:
        moved, ops = work(run["config"], x, actions)
        least += max(moved / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
    return 100.0 * least / seconds
