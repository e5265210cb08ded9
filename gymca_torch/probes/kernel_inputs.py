"""Inputs of the main paths' kernels, K1 and K2/K3, for checks and timings.

Shared by ``tests/test_torch_gpu.py`` and :mod:`gymca_torch.probes.ab_parent`:

* synthetic inputs from a ``torch.Generator``, with the layouts that can
  break each kernel's tiling (fire on tile edges, tiles beside burning
  ones, fire only in a tile's halo, edits and shots on band seams);
* the main paths driven with random actions, and the kernel's inputs
  recorded at each launch (:func:`record_windy_launches`,
  :func:`record_alexandridis_launches`, or :func:`alexandridis_recorder`
  around any code that steps the Advanced env, such as the trainer);
* :func:`k1_work`, the bytes and operations K1 must move and do on given
  inputs (K2's count is ``alexandridis_kernel.alexandridis_work``), and the
  least time the card could take for them, :func:`k1_bound` and
  :func:`k2_bound`, at an H100's peak rates;
* :func:`time_k1` and :func:`time_k2`: a kernel's device time per launch on
  given inputs beside that bound;
* :func:`launch_recorder`: copies of a kernel's inputs at chosen launches of
  any code that calls it.

Everything is made on ``device`` ("cuda" unless the caller says otherwise).
"""

from __future__ import annotations

import contextlib

import torch

from gymca_torch.ops.windy_kernel import CLUSTER_BLOCKS

__all__ = ["OPS_PER_CELL", "k1_work", "windy_inputs", "draw_actions", "run_steps",
           "record_windy_launches", "alexandridis_inputs", "alexandridis_keywords",
           "adv_actions", "adv_run", "alexandridis_recorder", "launch_recorder",
           "record_alexandridis_launches", "WINDY_CELLS", "K2_LAYOUTS",
           "HBM_BYTES_PER_S", "INT32_OPS_PER_S", "FP32_OPS_PER_S", "k1_bound", "k2_bound",
           "time_k1", "time_k2"]

WINDY_CELLS = (0, 3, 25)  # empty, tree, fire of the windy env's grids
# H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s of HBM3.  Integer ALU rate:
# the 67 TFLOP/s float32 peak counts an FMA as two operations on 128 lanes
# per SM; Hopper's SM has 64 int32 lanes, so 67 / 4 = 16.75 T int32 ops/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.75e12
FP32_OPS_PER_S = 67e12
# Integer operations K1's function needs per cell of a CA env: two compares
# to classify the cell, two selects to write it back, and the word-parallel
# stencil (about 40 operations per 32-cell word, counted from the kernel).
OPS_PER_CELL = 4 + 40 / 32


def k1_work(grid, params, edit_counts, k):
    """Bytes K1 must move and integer operations it must do for one launch
    on these inputs, with the env classes counted: every env's params read
    (16 B) and counts written (12 B); a CA env's weights (32 B), edit count
    (4 B), its replayed edit words (4 B each) and its grid read and written
    once; a modify-only env's cell read and written.  Returns ``(bytes, ops,
    CA envs, modify-only envs, replayed edits)``."""
    n, h, w = grid.shape
    item = grid.element_size()
    ca = params[:, 0] > 0
    n_ca = int(ca.sum())
    n_mod = int((~ca & (params[:, 3] > 0)).sum())
    n_edits = int(edit_counts.clamp(0, k)[ca].sum())
    moved = (n * (16 + 12) + n_ca * (32 + 4 + 2 * h * w * item) + 4 * n_edits
             + n_mod * 2 * item)
    return moved, n_ca * h * w * OPS_PER_CELL, n_ca, n_mod, n_edits


def k1_bound(grid, kin) -> dict:
    """K1's least time (ms) on ``grid`` for launches ``kin`` ((weights,
    params, edits, edit_counts) each), the mean over the launches of
    :func:`k1_work`: the larger of its bytes at ``HBM_BYTES_PER_S`` and its
    operations at ``INT32_OPS_PER_S``.  Returns ``bound_ms``, ``by`` and the
    counts behind them."""
    work = [k1_work(grid, p_, c_, e_.shape[1]) for _, p_, e_, c_ in kin]
    moved, ops, n_ca, n_mod, n_edits = (sum(x) / len(work) for x in zip(*work))
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    bound_ms, by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    return dict(bound_ms=bound_ms, by=by, bytes=moved, bytes_ms=bytes_ms, ops_ms=ops_ms,
                ca=n_ca, modify=n_mod, edits=n_edits)


def k2_bound(launches) -> dict:
    """The Alexandridis kernel's least time (ms) for ``launches`` ((x, kw)
    each), the mean over the launches of ``alexandridis_work``, for these
    inputs and dense (every cell a candidate): each the larger of the bytes
    at ``HBM_BYTES_PER_S`` and the operations at the int32 or float32 rate.
    Returns ``bound_ms``, ``by``, ``dense_ms``, ``dense_by`` and ``work``, the
    mean counts."""
    from gymca_torch.ops.alexandridis_kernel import alexandridis_work

    work = [alexandridis_work(x, kw) for x, kw in launches]
    avg = {k: sum(w[k] for w in work) / len(work) for k in work[0]}

    def bound(b, i, f):
        ops = max(i / INT32_OPS_PER_S, f / FP32_OPS_PER_S)
        return max((b / HBM_BYTES_PER_S * 1e3, "bytes"), (ops * 1e3, "operations"))

    bound_ms, by = bound(avg["bytes"], avg["int_ops"], avg["float_ops"])
    dense_ms, dense_by = bound(avg["dense_bytes"], avg["dense_int_ops"], avg["dense_float_ops"])
    return dict(bound_ms=bound_ms, by=by, dense_ms=dense_ms, dense_by=dense_by, work=avg)


def k1_pass(grid, kin, repeats):
    """``repeats`` passes of K1 over launches ``kin`` ((weights, params,
    edits, edit_counts) each) on ``grid``, in place."""
    from gymca_torch.ops.windy_kernel import windy_fused_step

    for _ in range(repeats):
        for w_, p_, e_, c_ in kin:
            windy_fused_step(grid, w_, p_, e_, c_, empty=0, tree=3, fire=25)


def time_k1(card, label, grid0, kin, repeats):
    """K1's device time per call (its light and CA passes) over ``repeats``
    passes of ``kin`` on a copy of ``grid0``, restored before every session,
    and its bound for these inputs (:func:`k1_bound`), printed: ``(ms,
    bound_ms, by)``."""
    from gymca_torch.probes.timing import time_launches

    grid = grid0.clone()
    t = time_launches(lambda: k1_pass(grid, kin, repeats), repeats * len(kin),
                      "windy_", reset=lambda: grid.copy_(grid0))
    b = k1_bound(grid0, kin)
    print(f"[time] [{card}] windy_sparse {label}: {t['device_us']} us/call of device time "
          f"(light pass + CA pass, each kernel's own median: {t['kernels']}), median of 3 "
          f"sessions of {t['launches']} calls (events kept "
          f"{t['seen']}), {b['ca']} CA envs with {b['edits']} replayed edits and "
          f"{b['modify']} modify-only envs of {grid0.shape[0]}; bound {b['bound_ms'] * 1e3} us "
          f"by {b['by']} (bytes: {b['bytes'] / 1e6} MB/call at 3.35 TB/s = "
          f"{b['bytes_ms'] * 1e3} us; operations: {OPS_PER_CELL}/cell at 16.75 T int32 ops/s "
          f"= {b['ops_ms'] * 1e3} us)", flush=True)
    return t["device_us"] / 1e3, b["bound_ms"], b["by"]


def time_k2(card, label, launches, repeats):
    """The Alexandridis kernel's device time per launch over ``repeats``
    passes of ``launches`` ((x, kw) each), and its bounds (:func:`k2_bound`:
    10 B a cell, dousing a cell within 2 of a candidate, vdf and the burning
    directions' planes a candidate, threefry and the box sums a candidate;
    dense, 29 B a cell, every cell a candidate), printed.  Returns ``(ms,
    bound_ms, by, dense_ms)``."""
    from gymca_torch.ops.alexandridis_kernel import alexandridis_fused_step
    from gymca_torch.probes.timing import time_launches

    def run():
        for _ in range(repeats):
            for x, kw in launches:
                alexandridis_fused_step(**x, **kw)

    t = time_launches(run, repeats * len(launches), "alexandridis_kernel")
    b = k2_bound(launches)
    avg = b["work"]
    n, h, w = launches[0][0]["grid"].shape
    print(f"[time] [{card}] alexandridis {label} ({n} x {h}x{w}, radius "
          f"{len(launches[0][1]['layer_coeffs'])}): {t['device_us']} us/launch of device "
          f"time, median of 3 sessions of {t['launches']} launches (events kept {t['seen']}), "
          f"{len(launches)} input(s); candidates {avg['candidates'] / avg['cells']} of the "
          f"cells, {avg['candidate_directions'] / max(avg['candidates'], 1)} burning "
          f"directions each, {avg['doused_cells'] / avg['cells']} of the cells within reach "
          f"of one; bound for these inputs {b['bound_ms'] * 1e3} us by {b['by']} "
          f"({avg['bytes'] / 1e6} MB at 3.35 TB/s = {avg['bytes'] / HBM_BYTES_PER_S * 1e6} "
          f"us; {avg['int_ops'] / 1e6} M int32 at 16.75 T/s = "
          f"{avg['int_ops'] / INT32_OPS_PER_S * 1e6} us, {avg['float_ops'] / 1e6} M float32 "
          f"at 67 T/s = {avg['float_ops'] / FP32_OPS_PER_S * 1e6} us); dense bound "
          f"{b['dense_ms'] * 1e3} us by {b['dense_by']} ({avg['dense_bytes'] / 1e6} MB)",
          flush=True)
    return t["device_us"] / 1e3, b["bound_ms"], b["by"], b["dense_ms"]


def windy_inputs(n, h, w, dtype, k, gen, device="cuda", classes="mixed", seams=False):
    """K1 inputs: ``(grid, weights, params, edits, edit_counts)``.

    ``classes``: "mixed" (3 in 10 CA envs, some without fire, 3 in 10
    modify-only, the rest idle), or "ca", "modify" or "idle" for every env.
    Shots fall on trees and non-trees.  ``seams``: the CA pass's band seams
    (every ceil(h / CLUSTER_BLOCKS) rows) carry fire on both sides, and
    every edit and shot falls on a band's first or last row."""
    def rand(*shape, high):
        return torch.randint(0, high, shape, generator=gen, device=device)

    empty, tree, fire = WINDY_CELLS
    cell = rand(n, h, w, high=10)
    grid = torch.where(cell < 2, empty, torch.where(cell < 9, tree, fire))
    no_fire = rand(n, high=8) == 0
    grid = torch.where(no_fire[:, None, None] & (grid == fire), tree, grid)
    band = -(-h // CLUSTER_BLOCKS)
    if seams:
        rows = torch.arange(h, device=device)
        seam = ((rows % band == 0) | (rows % band == band - 1))[None, :, None]
        grid = torch.where(seam & (rand(n, h, w, high=3) == 0), fire, grid)
    grid = grid.to(dtype)
    cls = rand(n, high=10)  # 0-2 CA, 3-5 modify-only, rest idle
    if classes != "mixed":
        cls = torch.full_like(cls, {"ca": 0, "modify": 3, "idle": 9}[classes])
    do_ca = (cls < 3).to(torch.int32)
    shoot = ((cls < 6) & (rand(n, high=4) > 0)).to(torch.int32)

    def rows_of(*shape):
        r = rand(*shape, high=h)
        if seams:  # a band's first or last row
            r = (r // band) * band + (band - 1) * rand(*shape, high=2)
            r = r.clamp(max=h - 1)
        return r

    row, col = rows_of(n).to(torch.int32), rand(n, high=w).to(torch.int32)
    params = torch.stack([do_ca, row, col, shoot], dim=-1).contiguous()
    weights = (rand(n, 8, high=2) * 8).to(torch.int32)
    edits = (rows_of(n, k) | (rand(n, k, high=w) << 16)).to(torch.int32)
    edit_counts = rand(n, high=k + 1).to(torch.int32)
    return grid, weights, params, edits, edit_counts


def draw_actions(gen, steps, n, device="cuda"):
    """Random (steps, n, 2) int32 windy actions from one torch.randint launch."""
    r = torch.randint(0, 18, (steps, n), generator=gen, device=device)
    return torch.stack([r // 2, r % 2], dim=-1).to(torch.int32)


def run_steps(core, states, actions):
    for a in actions:
        states, out = core.step_batched(states, a)
    return states, out


def record_windy_launches(core, states, actions):
    """Step the windy main path and keep copies of K1's inputs at each
    launch: a list of ``(grid, weights, params, edits, edit_counts)``."""
    import gymca_torch.envs.bulldozer as bulldozer

    with launch_recorder(bulldozer, "windy_fused_step") as recorded:
        run_steps(core, states, actions)
    return [args for args, _ in recorded]


# Layouts of the synthetic K2 inputs, against the kernel's 32 x 64 tiles.
K2_LAYOUTS = ("random", "tile_edges", "checker_tiles", "halo_only", "all_fire", "no_fire")


def alexandridis_inputs(n, h, w, gen, device="cuda", layout="random", radius=None):
    """K2 inputs from a generator, and the env's keywords at that size
    (the radius of ``AlexandridisCA(h)``, or ``radius``): fires, dousing,
    terrain factors away from 1 and ages at and around 1.

    ``layout`` (one of ``K2_LAYOUTS``): "random" 10% fire and 75% trees;
    "tile_edges" fire only on the first and last row and column of each
    32 x 64 tile; "checker_tiles" the random layout in every other tile, the
    rest trees without fire; "halo_only" trees, with fire on rows 31 mod 64
    and columns 63 mod 128, so every other tile's only fire lies in its
    1-cell halo; "all_fire" and "no_fire"."""
    from gymca_torch.ops.alexandridis import AlexandridisCA

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    cells = rand(n, h, w)
    grid = torch.where(cells < 0.1, 2, torch.where(cells < 0.85, 1, 0))
    r = torch.arange(h, device=device)[:, None]
    c = torch.arange(w, device=device)[None, :]
    if layout == "tile_edges":
        edge = (r % 32 == 0) | (r % 32 == 31) | (c % 64 == 0) | (c % 64 == 63)
        grid = torch.where(edge & (cells < 0.3), 2, torch.where(cells < 0.85, 1, 0))
        grid = torch.where(~edge & (grid == 2), 1, grid)
    elif layout == "checker_tiles":
        grid = torch.where(((r // 32 + c // 64) % 2 == 1) & (grid == 2), 1, grid)
    elif layout == "halo_only":
        grid = torch.where((r % 64 == 31) | (c % 128 == 63), 2, 1).expand(n, h, w)
    elif layout == "all_fire":
        grid = torch.full_like(grid, 2)
    elif layout == "no_fire":
        grid = torch.where(grid == 2, 1, grid)
    elif layout != "random":
        raise ValueError(f"layout must be one of {K2_LAYOUTS}, got {layout!r}")
    ages = torch.tensor([0.5, 1.0, 1.5, 2.0, 60.0], device=device)
    x = dict(
        grid=grid.to(torch.int8).contiguous(),
        fire_age=ages[torch.randint(0, 5, (n, h, w), generator=gen, device=device)],
        dousing=(rand(n, h, w) < 0.05).to(torch.int8),
        vdf=(0.5 + 2.5 * rand(n, h, w)).to(torch.bfloat16),
        exp_slope=(0.8 + 0.45 * rand(n, 3, 3, h, w)).to(torch.bfloat16),
        wind_rows=0.5 + 3.5 * rand(n, 8),
        seeds=torch.randint(0, 2**32, (n, 2), generator=gen, device=device,
                            dtype=torch.int64),
    )
    return x, alexandridis_keywords(AlexandridisCA(h), radius)


def alexandridis_keywords(ca, radius=None):
    """The kernel's keywords for ``ca``, at its own radius or ``radius``."""
    from gymca_torch.ops.alexandridis import burn_kernel_layer_weights
    from gymca_torch.ops.stencil import telescoped_box_coeffs

    weights = ca.burn_layer_weights if radius is None else burn_kernel_layer_weights(radius)
    return dict(empty=ca.empty, tree=ca.tree, fire=ca.fire,
                layer_coeffs=telescoped_box_coeffs(weights),
                dousing_border=float(ca._dousing_border),
                dousing_inner=float(ca._dousing_inner),
                fire_age_min=int(ca.fire_age_min), fire_age_max=int(ca.fire_age_max))


def adv_actions(gen, steps, n, device="cuda"):
    """Random (steps, n, 3) int32 Advanced actions (move 0-8, shoot 0-1,
    extension 0) from one torch.randint launch."""
    r = torch.randint(0, 18, (steps, n), generator=gen, device=device)
    return torch.stack([r // 2, r % 2, torch.zeros_like(r)], dim=-1).to(torch.int32)


def adv_run(env, obs, info, actions, reward_sums=None):
    """``stateless_step`` then ``conditional_reset`` per action; returns the
    last observation and info and the last ``stateless_step`` tuple.  Each
    step's reward summed over the envs is appended to ``reward_sums`` if it
    is a list, as ``bench.py``'s loop sums it."""
    for a in actions:
        step = env.stateless_step(a, obs, info)
        if reward_sums is not None:
            reward_sums.append(step[1].sum())
        reset = env.conditional_reset(step, a)
        obs, info = reset[0], reset[4]
    return obs, info, step


@contextlib.contextmanager
def launch_recorder(module, name, keep=None, record=None):
    """While open, ``module.<name>`` (a kernel's wrapper as the code under
    test looks it up: a module that imported it by name, never the kernel's
    own module, whose wrapper counts its launches through that name) keeps
    copies of its inputs at each call whose index (0
    for the first call inside the block) is in ``keep``, or for which
    ``keep(index, args, kw)`` is true when ``keep`` is callable, or at every
    call if ``keep`` is None: ``record(args, kw)`` of the copied positional
    and keyword arguments, ``(args, kw)`` by default.  Yields the list it
    fills."""
    real = getattr(module, name)
    recorded, seen = [], [0]
    if keep is None:
        wanted = lambda i, args, kw: True  # noqa: E731
    elif callable(keep):
        wanted = keep
    else:
        wanted = lambda i, args, kw: i in keep  # noqa: E731

    def copy(v):
        return v.clone() if isinstance(v, torch.Tensor) else v

    def recorder(*args, **kw):
        if wanted(seen[0], args, kw):
            a, k = tuple(copy(v) for v in args), {n: copy(v) for n, v in kw.items()}
            recorded.append(record(a, k) if record else (a, k))
        seen[0] += 1
        return real(*args, **kw)

    setattr(module, name, recorder)
    try:
        yield recorded
    finally:
        setattr(module, name, real)


def alexandridis_recorder(keep=None, module=None):
    """:func:`launch_recorder` of the Alexandridis kernel as ``module`` calls
    it (the Advanced env, ``gymca_torch.envs.advanced``, by default), with
    every positional input: each record is ``(x, kw)``, ``x`` the inputs by
    name."""
    import gymca_torch.envs.advanced as advanced

    names = ("grid", "fire_age", "dousing", "vdf", "exp_slope", "wind_rows", "seeds")
    return launch_recorder(module or advanced, "alexandridis_fused_step", keep,
                           lambda a, kw: (dict(zip(names, a)), kw))


def record_alexandridis_launches(env, obs, info, actions):
    """Step the Advanced path and keep copies of the kernel's inputs at each
    launch: a list of ``(x, kw)``."""
    with alexandridis_recorder() as recorded:
        adv_run(env, obs, info, actions)
    return recorded
