#!/usr/bin/env python3
"""Drive gymca_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

The main path is ``BulldozerCore(256, 256).step_batched`` over 4096 envs
(256 MiB of int8 grid), carried by kernel K1 (``gymca_torch/csrc/
windy_sparse.cu``).  Phases, each fatal on failure:

1. device line: card, count, torch and CUDA versions, ``nvidia-smi`` name and
   power limit;
2. build every ``gymca_torch/csrc/*.cu`` from the checkout, with the ptxas
   report;
3. K1 against its plain version at (4096, 256, 256) int8 with every env
   class, deferred edits and shots on trees and non-trees (tolerance 0);
4. the same at (64, 64, 128) int32, at (16, 40, 50) int8, whose rows take
   the kernel's one-cell-per-lane path, and at (8, 512, 512) int8, whose bit
   masks pass 48 KiB of shared memory;
5. the main path: reset 4096 envs, step them with random actions from a CUDA
   ``torch.Generator`` under ``torch.cuda.set_sync_debug_mode("error")``,
   K1's launch counter zeroed before and read after; then ``step_batched``
   against the eager batched step ``step`` on 64 envs, bit for bit, and K1
   against its plain version on inputs recorded from the main path;
6. times beside the card's name and power limit: env-steps/s; K1's device
   time per launch and its no-op floor, from the profiler's kernel events;
   its bound for the bytes and operations of the recorded launches; its
   plain version; and a profiler trace of the step (device kernels per
   step, idle share, time by kernel);
7. one JSON line describing every kernel;
8. the ``nvidia-smi`` line, then the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.  It exits non-zero, printing no result, without a
CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
N_ENVS, H, W = 4096, 256, 256
SEED = 0
MAIN_STEPS = 200
PARITY_ENVS, PARITY_STEPS = 64, 100
TIMING_REPS = 3
PROFILE_STEPS = 10
RECORDED_LAUNCHES = 10
KERNEL_REPEATS = 10  # passes over the recorded launches when timing K1

# H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s of HBM3.  Integer ALU rate:
# the 67 TFLOP/s float32 peak counts an FMA as two operations on 128 lanes
# per SM; Hopper's SM has 64 int32 lanes, so 67 / 4 = 16.75 T int32 ops/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.75e12
# Integer operations K1's function needs per cell of a CA env: two compares
# to classify the cell, two selects to write it back, and the word-parallel
# stencil (about 40 operations per 32-cell word, counted from the kernel).
OPS_PER_CELL = 4 + 40 / 32


def log(*parts):
    print(*parts, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean time of ``fn()`` over ``reps`` calls between two CUDA events,
    host launch time included."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, reps: int):
    """Mean device duration of K1's kernel over ``reps`` calls of ``fn``, and
    the number of kernels seen, from the profiler's CUDA kernel events: the
    kernel's own time on the card, with no host time between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and "windy_sparse_kernel" in e.name]
    if not us:
        fail("the profiler shows no device time for windy_sparse_kernel")
    return sum(us) / len(us) / 1e3, len(us)


def k1_work(grid, params, edit_counts, k):
    """Bytes K1 must move and integer operations it must do for one launch
    on these inputs, with the env classes counted: every env's params read
    (16 B) and counts written (12 B); a CA env's weights (32 B), edit count
    (4 B), its replayed edit words (4 B each) and its grid read and written
    once; a modify-only env's cell read and written."""
    n, h, w = grid.shape
    item = grid.element_size()
    ca = params[:, 0] > 0
    n_ca = int(ca.sum())
    n_mod = int((~ca & (params[:, 3] > 0)).sum())
    n_edits = int(edit_counts.clamp(0, k)[ca].sum())
    moved = (n * (16 + 12) + n_ca * (32 + 4 + 2 * h * w * item) + 4 * n_edits
             + n_mod * 2 * item)
    return moved, n_ca * h * w * OPS_PER_CELL, n_ca, n_mod, n_edits


# --- kernel inputs -------------------------------------------------------------


def synthetic_inputs(n, h, w, dtype, k, gen):
    """K1 inputs with every env class: CA envs (some without fire, some
    with deferred edits, shots on trees and non-trees), modify-only envs
    and idle envs."""
    dev = "cuda"

    def rand(*shape, high):
        return torch.randint(0, high, shape, generator=gen, device=dev)

    cell = rand(n, h, w, high=10)
    grid = torch.where(cell < 2, 0, torch.where(cell < 9, 3, 25)).to(dtype)
    no_fire = rand(n, high=8) == 0
    grid = torch.where(no_fire[:, None, None] & (grid == 25), 3, grid).to(dtype)
    cls = rand(n, high=10)  # 0-2 CA, 3-5 modify-only, rest idle
    do_ca = (cls < 3).to(torch.int32)
    shoot = ((cls < 6) & (rand(n, high=4) > 0)).to(torch.int32)
    row, col = rand(n, high=h).to(torch.int32), rand(n, high=w).to(torch.int32)
    params = torch.stack([do_ca, row, col, shoot], dim=-1).contiguous()
    weights = (rand(n, 8, high=2) * 8).to(torch.int32)
    edits = (rand(n, k, high=h) | (rand(n, k, high=w) << 16)).to(torch.int32)
    edit_counts = rand(n, high=k + 1).to(torch.int32)
    return grid, weights, params, edits, edit_counts


def kernel_vs_plain(inputs, empty=0, tree=3, fire=25):
    """Max |kernel - plain| over grids and counts on the same inputs."""
    from gymca_torch.ops.windy_kernel import windy_fused_step, windy_fused_step_plain

    grid, weights, params, edits, edit_counts = inputs
    g_k, c_k = windy_fused_step(grid.clone(), weights, params, edits, edit_counts,
                                empty=empty, tree=tree, fire=fire)
    g_p, c_p = windy_fused_step_plain(grid.clone(), weights, params, edits, edit_counts,
                                      empty=empty, tree=tree, fire=fire)
    torch.cuda.synchronize()
    err = max(
        (g_k.to(torch.int32) - g_p.to(torch.int32)).abs().max().item(),
        (c_k - c_p).abs().max().item(),
    )
    return err, c_p


def check_kernel(label, inputs):
    err, counts = kernel_vs_plain(inputs)
    params = inputs[2]
    n_ca = int((params[:, 0] > 0).sum())
    n_mod = int(((params[:, 0] == 0) & (params[:, 3] > 0)).sum())
    n_hits = int(counts[:, 2].sum())
    log(f"[kernel] windy_sparse {tuple(inputs[0].shape)} {inputs[0].dtype}: "
        f"{n_ca} CA envs, {n_mod} modify-only, {n_hits} hits, "
        f"max_abs_err {err} (tolerance 0)")
    if err != 0:
        fail(f"windy_sparse disagrees with its plain version at {label}")
    return err


# --- the main path -----------------------------------------------------------------


def draw_actions(gen, steps, n):
    """Random (steps, n, 2) int32 actions from one torch.randint launch."""
    r = torch.randint(0, 18, (steps, n), generator=gen, device="cuda")
    return torch.stack([r // 2, r % 2], dim=-1).to(torch.int32)


def run_steps(core, states, actions):
    for a in actions:
        states, out = core.step_batched(states, a)
    return states, out


def record_kernel_inputs(core, states, actions):
    """Step the main path and keep copies of K1's inputs at each launch."""
    import gymca_torch.envs.bulldozer as bulldozer

    real = bulldozer.windy_fused_step
    recorded = []

    def recorder(grid, weights, params, edits, edit_counts, **kw):
        recorded.append(tuple(t.clone() for t in (grid, weights, params, edits,
                                                   edit_counts)))
        return real(grid, weights, params, edits, edit_counts, **kw)

    bulldozer.windy_fused_step = recorder
    try:
        run_steps(core, states, actions)
    finally:
        bulldozer.windy_fused_step = real
    return recorded


def parity(core, keys, gen):
    """step_batched against the eager batched step, bit for bit."""
    a = core.initial_state(keys)
    b = a.clone()
    actions = draw_actions(gen, PARITY_STEPS, keys.shape[0])
    mismatches = []
    for i, act in enumerate(actions):
        a, out_a = core.step_batched(a, act)
        b, out_b = core.step(b, act)
        pairs = {
            "reward": (out_a.reward, out_b.reward),
            "done": (out_a.terminated, out_b.terminated),
            "hit": (out_a.info["hit"], out_b.info["hit"]),
            "tree_count": (a.context["tree_count"], b.context["tree_count"]),
            "fire_count": (a.context["fire_count"], b.context["fire_count"]),
            "position": (a.context["position"], b.context["position"]),
            "time": (a.context["time"], b.context["time"]),
            "key": (a.key, b.key),
            "grid": (core.materialize_grid(a), b.grid),
        }
        for name, (x, y) in pairs.items():
            if not torch.equal(x, y):
                mismatches.append(f"step {i} {name}")
        if not torch.isfinite(out_a.reward).all():
            mismatches.append(f"step {i} non-finite reward")
    return mismatches, float(b.done.float().mean())


# --- profile -----------------------------------------------------------------------


def profile_steps(core, states, actions, card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run_steps(core, states, actions[:2])  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_steps(core, states, actions)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    steps = len(actions)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        log(f"[profile] [{card}] the profiler shows no device time; device "
            f"kernels per step not measured")
        return None
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    idle = 1.0 - busy / span
    log(f"[profile] [{card}] step_batched {N_ENVS} x {H}x{W}, {steps} steps traced: "
        f"{len(spans) / steps} device kernels/step, device busy {busy / steps} us/step "
        f"of a {span / steps} us/step device span (idle share {idle}); host wall "
        f"under the profiler {host_s * 1e6 / steps} us/step")
    rows = sorted(
        (e for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.device_time_total > 0),
        key=lambda e: e.device_time_total, reverse=True,
    )
    for e in rows[:12]:
        log(f"[profile]   {e.device_time_total / steps:10.1f} us/step "
            f"{e.count / steps:8.1f} launches/step "
            f"{100 * e.device_time_total / busy:5.1f}%  {e.key[:90]}")
    return {"kernels_per_step": len(spans) / steps, "idle_share": idle}


# --- main ----------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the card and has no CPU path")
    sys.path.insert(0, str(HERE))
    import gymca_torch

    if Path(gymca_torch.__file__).resolve().parent.parent != HERE:
        fail(f"gymca_torch imported from {gymca_torch.__file__}, not this checkout")
    from gymca_torch import _build, rng
    from gymca_torch.envs.bulldozer import BulldozerCore, derive_step_key
    from gymca_torch.ops.windy_kernel import windy_fused_step, windy_fused_step_plain

    # 1. device
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[device] {name} x{count} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {smi}")
    card = smi

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {len(built)} source(s) in {time.perf_counter() - t0:.1f}s: " + ", ".join(
        f"{b.name} {'reused' if b.seconds is None else f'{b.seconds:.1f}s'}"
        for b in built.values()))
    for b in built.values():
        for line in b.ptxas_report():
            log(f"[build] {b.name}: {line}")

    # 3-4. kernel against plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    k_main = BulldozerCore(H, W)._edit_log_k
    max_err = max(
        check_kernel("main shape", synthetic_inputs(N_ENVS, H, W, torch.int8, k_main, gen)),
        check_kernel("int32", synthetic_inputs(64, 64, 128, torch.int32, 5, gen)),
        check_kernel("odd width", synthetic_inputs(16, 40, 50, torch.int8, 3, gen)),
        check_kernel("past 48 KiB", synthetic_inputs(8, 512, 512, torch.int8, 5, gen)),
    )

    # 5. main path
    core = BulldozerCore(H, W)
    keys = rng.split(rng.key(SEED, device="cuda"), N_ENVS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_states = core.initial_state(keys)
    torch.cuda.synchronize()
    log(f"[main] reset {N_ENVS} envs at {H}x{W} {reset_states.grid.dtype} "
        f"({reset_states.grid.numel() * reset_states.grid.element_size() / 2**20:.0f} "
        f"MiB of grid) in {time.perf_counter() - t0:.2f}s; edit log K={core._edit_log_k}")
    actions = draw_actions(gen, MAIN_STEPS, N_ENVS)
    states = reset_states.clone()
    torch.cuda.synchronize()
    windy_fused_step.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        states, out = run_steps(core, states, actions)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = windy_fused_step.launches
    torch.cuda.synchronize()
    log(f"[main] {MAIN_STEPS} steps of step_batched under sync_debug_mode=error: "
        f"{launches} windy kernel launches, done fraction "
        f"{states.done.float().mean().item()}")
    if launches != MAIN_STEPS:
        fail(f"expected {MAIN_STEPS} windy kernel launches on the main path, got {launches}")
    if out.reward.shape != (N_ENVS,) or not torch.isfinite(out.reward).all():
        fail("main path rewards are not finite (N,) values")

    mismatches, parity_done = parity(core, keys[:PARITY_ENVS], gen)
    if mismatches:
        fail(f"step_batched differs from the eager step: {mismatches[:10]}")
    log(f"[main] first {PARITY_ENVS} envs x {PARITY_STEPS} steps: rewards, dones, hits, "
        f"counts, positions, times, keys and materialized grids equal the eager "
        f"batched step bit for bit (done fraction {parity_done})")

    # Recorded from where the main path ended: by then the envs' CA periods
    # have drifted apart, as in a long run (from a reset they fire together).
    recorded = record_kernel_inputs(core, states.clone(),
                                    draw_actions(gen, RECORDED_LAUNCHES, N_ENVS))
    rec_err = max(kernel_vs_plain(inp)[0] for inp in recorded[:3])
    log(f"[kernel] windy_sparse on main-path inputs (3 recorded launches): "
        f"max_abs_err {rec_err} (tolerance 0)")
    if rec_err != 0:
        fail("windy_sparse disagrees with its plain version on main-path inputs")
    max_err = max(max_err, rec_err)

    # 6. times
    rates = []
    for rep in range(TIMING_REPS):
        s = reset_states.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, _ = run_steps(core, s, actions)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.append((N_ENVS * MAIN_STEPS / dt, dt, float(s.done.float().mean())))
    best = max(rates)
    log(f"[time] [{card}] step_batched {N_ENVS} x {H}x{W}, {MAIN_STEPS} steps, best of "
        f"{TIMING_REPS}: {best[0]} env-steps/s ({best[1] * 1e3 / MAIN_STEPS} ms/step); "
        f"reps " + ", ".join(f"{r[0]} env-steps/s (done fraction {r[2]})" for r in rates))

    grid = recorded[0][0].clone()
    kin = [inp[1:] for inp in recorded]

    def kernel_pass():
        for w_, p_, e_, c_ in kin:
            windy_fused_step(grid, w_, p_, e_, c_, empty=0, tree=3, fire=25)

    kernel_pass()  # warm
    kernel_ms, kernel_n = kernel_device_ms(kernel_pass, KERNEL_REPEATS)
    work = [k1_work(grid, p_, c_, e_.shape[1]) for _, p_, e_, c_ in kin]
    bytes_moved, ops, n_ca, n_mod, n_edits = (sum(x) / len(work) for x in zip(*work))
    bytes_ms, ops_ms = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    noop = torch.zeros_like(kin[0][1])
    noop_ms, noop_n = kernel_device_ms(
        lambda: windy_fused_step(grid, kin[0][0], noop, kin[0][2], kin[0][3],
                                 empty=0, tree=3, fire=25), 100)
    plain_grid = grid.clone()
    plain_ms = cuda_ms(lambda: windy_fused_step_plain(plain_grid, *kin[0], empty=0, tree=3,
                                                      fire=25), 3)
    log(f"[time] [{card}] windy_sparse kernel: {kernel_ms * 1e3} us/launch of device "
        f"time over {kernel_n} launches cycling {len(kin)} recorded main-path launches "
        f"({n_ca} CA envs with {n_edits} replayed edits and {n_mod} modify-only envs per "
        f"launch of {N_ENVS}); bound {bound_ms * 1e3} us by {bound_by} (bytes: "
        f"{bytes_moved / 1e6} MB/launch at 3.35 TB/s = {bytes_ms * 1e3} us; operations: "
        f"{OPS_PER_CELL}/cell at 16.75 T int32 ops/s = {ops_ms * 1e3} us); plain version "
        f"{plain_ms * 1e3} us/call (CUDA events); every env a no-op {noop_ms * 1e3} "
        f"us/launch of device time over {noop_n} launches")

    s = reset_states.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        derive_step_key(s.key)
    torch.cuda.synchronize()
    key_us = (time.perf_counter() - t0) / 20 * 1e6
    t0 = time.perf_counter()
    s, _ = run_steps(core, s, actions[:20])
    torch.cuda.synchronize()
    step_us = (time.perf_counter() - t0) / 20 * 1e6
    log(f"[time] [{card}] parts of a step, host clock to a synchronize: step "
        f"{step_us} us, derive_step_key {key_us} us; windy kernel device time "
        f"{kernel_ms * 1e3} us")

    prof = profile_steps(core, reset_states.clone(), actions[:PROFILE_STEPS], card)

    # 7-8. result lines
    kernels = [{
        "name": "windy_sparse",
        "route": "cuda",
        "source": "gymca_torch/csrc/windy_sparse.cu",
        "replaces": "gymca_tpu/ops/pallas_kernels.py:516",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    log(json.dumps({"kernels": kernels}))
    if prof is not None:
        log(json.dumps({"step": {"env_steps_per_sec": best[0], **prof}}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
