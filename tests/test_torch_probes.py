"""The port's probes (``gymca_torch.probes``) against the JAX package and
their contracts, on the CPU.

* The four windy-CA formulations' plain versions against the bodies of
  ``scripts/exp_ca_variants.py``, run by a ``pl.pallas_call`` built here as
  the script's ``run_variant`` builds it, in interpret mode; and, chained,
  against ``windy_step_from_success``.
* The Alexandridis step's ablations against the interpreted JAX kernel
  (``ablate=...``), with the port's draws replaced by zeros (the
  interpreter's PRNG is a zero stub).
* ``dma_floor`` and ``probe_floor``: their plain versions against their
  contracts, the wrappers on the CPU and what they refuse.
* The entry points: on the CPU at toy sizes, and raising without a card.

The CUDA kernels themselves are held to these plain versions in
``tests/test_torch_gpu.py`` (``test_ca_variant_kernel_matches_plain_at_the_probes_sizes``,
``test_probe_entry_points_run_on_the_card`` and the kernels' own cases).
Tolerances: 0.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import gymca_torch.ops.alexandridis_kernel as ak
from gymca_torch import interop
from gymca_torch.probes import bench_fused_ca, exp_ca_variants, floor_kernel, timing
from gymca_torch.probes import ca_variants_kernel as cv
from gymca_torch.probes.dma_floor_kernel import dma_floor, dma_floor_plain, moved_bytes
from gymca_torch.probes.floor_kernel import FloorVariant, probe_floor, probe_floor_plain
from gymca_tpu.ops import alexandridis as jalex
from gymca_tpu.ops import stencil as jstencil
from gymca_tpu.ops.pallas_alexandridis import alexandridis_fused_step as jax_fused_step
from gymca_tpu.ops.windy import windy_step_from_success as jax_windy_step
from scripts import exp_ca_variants as script

EMPTY, TREE, FIRE = cv.EMPTY, cv.TREE, cv.FIRE
ENTRY_POINTS = ("exp_ca_variants", "bench_fused_ca", "exp_counts_out", "exp_launch_floor",
                "exp_kernel_overhead", "exp_floor")


def windy_case(seed, n, h, w, p_fire=0.1):
    """A grid of EMPTY/TREE/FIRE and 0/PROPAGATION gusts (p = 0.6), numpy."""
    r = np.random.default_rng(seed)
    grid = r.choice(np.asarray([EMPTY, TREE, FIRE], np.int8), (n, h, w),
                    p=(0.098, 0.902 - p_fire, p_fire))
    weights = ((r.random((n, 8)) < 0.6) * 8).astype(np.int32)
    return grid, weights


# --- S4: the four formulations ---------------------------------------------------------


SCRIPT_BODIES = {"banded": script.kernel_banded, "bool": script.kernel_bool,
                 "fma": script.kernel_fma, "swar": script.kernel_swar}


def script_step(body, grid, weights):
    """One step of the script's body over every env, as ``run_variant``
    calls it, in interpret mode: (new grid, [trees, fires])."""
    n, h, w = grid.shape
    out, counts = pl.pallas_call(
        body, grid=(n,),
        in_specs=[pl.BlockSpec((1, h, w), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, 1, 8), lambda i: (i, 0, 0), memory_space=pltpu.SMEM)],
        out_specs=(pl.BlockSpec((1, h, w), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
                   pl.BlockSpec((1, 1, 4), lambda i: (i, 0, 0), memory_space=pltpu.SMEM)),
        out_shape=(jax.ShapeDtypeStruct((n, h, w), jnp.int8),
                   jax.ShapeDtypeStruct((n, 1, 4), jnp.int32)),
        input_output_aliases={0: 0}, interpret=True,
    )(jnp.asarray(grid), jnp.asarray(weights[:, None, :]))
    return np.asarray(out), np.asarray(counts)[:, 0, :2]


@pytest.mark.parametrize("variant", cv.VARIANTS)
@pytest.mark.parametrize("seed,n,h,w", [(0, 2, 16, 128), (1, 3, 8, 256)])
def test_plain_formulation_equals_the_scripts_body(variant, seed, n, h, w):
    grid, weights = windy_case(seed, n, h, w)
    want_grid, want_counts = script_step(SCRIPT_BODIES[variant], grid, weights)
    got, counts = cv.PLAIN[variant](torch.tensor(grid), torch.tensor(weights))
    np.testing.assert_array_equal(got.numpy(), want_grid)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    success = np.zeros((n, 3, 3), bool)  # the JAX package's own rule, too
    for i, (dr, dc) in enumerate(jstencil.NEIGHBOR_OFFSETS):
        success[:, 1 - dr, 1 - dc] = weights[:, i] > 0
    ref = jax.vmap(lambda g, s: jax_windy_step(g, s, empty=EMPTY, tree=TREE, fire=FIRE))(
        jnp.asarray(grid), jnp.asarray(success))
    np.testing.assert_array_equal(want_grid, np.asarray(ref))
    assert (want_grid == FIRE).sum() > 0 and (grid == FIRE).sum() < (want_grid == FIRE).sum()


@pytest.mark.parametrize("variant", cv.VARIANTS)
@pytest.mark.parametrize("n,h,w", [(3, 16, 32), (2, 9, 20), (2, 7, 13)])
def test_plain_formulation_chained_equals_windy_step_from_success(variant, n, h, w):
    """Five steps of each plain version against the port's
    ``windy_step_from_success``, grid and counts after every step; widths
    that are not a multiple of 4 too (not for swar, whose wrapper raises)."""
    grid, weights = windy_case(n * h + w, n, h, w)
    weights_t = torch.tensor(weights)
    a, b = torch.tensor(grid), torch.tensor(grid)
    if variant == "swar" and w % 4:
        with pytest.raises(ValueError, match="W % 4"):
            cv.ca_variant_step(variant, a, weights_t)
        return
    for step in range(5):
        a, ca = cv.ca_variant_step(variant, a, weights_t)
        b, cb = cv.reference_step(b, weights_t)
        assert torch.equal(a, b), step
        assert torch.equal(ca, cb), step


def test_ca_wrapper_refuses_what_the_kernels_do_not_take():
    grid, weights = windy_case(3, 2, 8, 16)
    g, w = torch.tensor(grid), torch.tensor(weights)
    with pytest.raises(ValueError, match="variant"):
        cv.ca_variant_step("dense", g, w)
    with pytest.raises(ValueError):
        cv.ca_variant_step("bool", g.to(torch.int32), w)
    with pytest.raises(ValueError):
        cv.ca_variant_step("bool", g, w[:, :4].contiguous())
    launches = dict(cv.ca_variant_step.launches)
    cv.ca_variant_step("banded", g, w)
    assert cv.ca_variant_step.launches == launches  # no kernel on the CPU


def test_exp_ca_variants_runs_on_the_cpu():
    rows = exp_ca_variants.run(device="cpu", n=3, h=16, w=32, steps=6)
    assert [r["variant"] for r in rows] == list(cv.VARIANTS)
    assert all(r["equal"] and r["device_us"] is None for r in rows)


# --- the Alexandridis step's ablations ----------------------------------------------------


KW = dict(empty=0, tree=1, fire=2,
          layer_coeffs=jstencil.telescoped_box_coeffs(jalex.burn_kernel_layer_weights(2)),
          dousing_border=0.01, dousing_inner=0.1, fire_age_min=48, fire_age_max=56)


@pytest.fixture
def zero_draws(monkeypatch):
    def draws(seeds, h, w):
        n = seeds.shape[0]
        return torch.zeros((n, h, w)), torch.zeros((n, h, w), dtype=torch.int64)

    monkeypatch.setattr(ak, "alexandridis_draws", draws)


@pytest.mark.usefixtures("zero_draws")
@pytest.mark.parametrize("ablate", ["boxes", "ignite", "prng"])
def test_ablation_equals_the_interpreted_jax_kernel(ablate):
    """Random terrain factors, winds strong enough that trees ignite at
    u = 0.5, dousing and ages at and around 1, at (2, 8, 128)."""
    r = np.random.default_rng(21)
    n, h, w = 2, 8, 128
    grid = r.choice(np.asarray([0, 1, 1, 2], np.int32), (n, h, w))
    age = r.choice(np.asarray([0.5, 1.0, 1.5, 2.0, 50.0], np.float32), (n, h, w))
    dousing = (r.random((n, h, w)) < 0.1).astype(np.int32)
    vdf = jnp.asarray(r.uniform(0.5, 3.0, (n, h, w)).astype(np.float32)).astype(jnp.bfloat16)
    slope = jnp.asarray(r.uniform(0.8, 1.25, (n, 3, 3, h, w)).astype(np.float32)
                        ).astype(jnp.bfloat16)
    wind = r.uniform(0.0, 40.0, (n, 8)).astype(np.float32)
    seeds = np.asarray([[3, 17], [5, 23]])
    jg, ja = jax_fused_step(jnp.asarray(grid), jnp.asarray(age), jnp.asarray(dousing), vdf,
                            slope, jnp.asarray(wind), jnp.asarray(seeds, jnp.int32),
                            interpret=True, ablate=ablate, **KW)
    tg, ta = ak.alexandridis_fused_step(
        torch.tensor(grid, dtype=torch.int8), torch.tensor(age),
        torch.tensor(dousing, dtype=torch.int8), interop._bf16_from_numpy(np.asarray(vdf), "cpu"),
        interop._bf16_from_numpy(np.asarray(slope), "cpu"), torch.tensor(wind),
        torch.tensor(seeds), ablate=ablate, **KW)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    ignited = ((tg.numpy() == 2) & (grid == 1)).sum()
    assert ignited == 0 if ablate == "boxes" else ignited > 0  # heat lives on fires only


def test_ablation_prng_ignores_the_draws():
    """``prng`` takes u = 0.5 and new ages = fire_age_min whatever the seeds."""
    r = np.random.default_rng(22)
    x = dict(grid=torch.tensor(r.choice(np.asarray([0, 1, 2], np.int8), (2, 8, 16))),
             fire_age=torch.full((2, 8, 16), 50.0),
             dousing=torch.zeros((2, 8, 16), dtype=torch.int8),
             vdf=torch.full((2, 8, 16), 2.0).to(torch.bfloat16),
             exp_slope=torch.ones((2, 3, 3, 8, 16)).to(torch.bfloat16),
             wind_rows=torch.full((2, 8), 100.0))
    a = ak.alexandridis_fused_step(**x, seeds=torch.tensor([[1, 2], [3, 4]]), ablate="prng", **KW)
    b = ak.alexandridis_fused_step(**x, seeds=torch.tensor([[9, 8], [7, 6]]), ablate="prng", **KW)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    new_fire = (a[0] == 2) & (x["grid"] == 1)
    assert new_fire.any() and bool((a[1][new_fire] == KW["fire_age_min"]).all())


def test_ablate_rejects_unknown_phases():
    x = dict(grid=torch.zeros((1, 8, 16), dtype=torch.int8), fire_age=torch.zeros((1, 8, 16)),
             dousing=torch.zeros((1, 8, 16), dtype=torch.int8),
             vdf=torch.ones((1, 8, 16)).to(torch.bfloat16),
             exp_slope=torch.ones((1, 3, 3, 8, 16)).to(torch.bfloat16),
             wind_rows=torch.ones((1, 8)), seeds=torch.zeros((1, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="ablate"):
        ak.alexandridis_fused_step(**x, ablate="sat", **KW)


# --- S6: the streaming floor -------------------------------------------------------------


def dma_case(seed, n, h, w):
    r = np.random.default_rng(seed)
    return dict(
        grid=torch.tensor(r.integers(0, 3, (n, h, w)).astype(np.int8)),
        fire_age=torch.tensor(r.uniform(-2, 600, (n, h, w)).astype(np.float32)),
        dousing=torch.tensor(r.integers(-128, 128, (n, h, w)).astype(np.int8)),
        vdf=torch.tensor(r.integers(0, 2**16, (n, h, w)).astype(np.uint16).view(np.int16)
                         ).view(torch.bfloat16),
        exp_slope=torch.tensor(r.integers(0, 2**16, (n, 3, 3, h, w)).astype(np.uint16)
                               .view(np.int16)).view(torch.bfloat16),
        wind_rows=torch.tensor(r.uniform(0, 4, (n, 8)).astype(np.float32)),
        seeds=torch.tensor(r.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.int64)),
    )


def numpy_fold(x, e):
    """The XOR of env e's 32-bit words of every streamed input but grid and
    age, the centre slope plane left out, in numpy."""
    parts = [x["dousing"][e].numpy(), x["vdf"][e].view(torch.int16).numpy(),
             np.delete(x["exp_slope"][e].view(torch.int16).numpy().reshape(9, -1), 4, axis=0),
             x["wind_rows"][e].numpy(), x["seeds"][e].numpy()]
    acc = np.uint32(0)
    for p in parts:
        acc ^= np.bitwise_xor.reduce(np.ascontiguousarray(p).ravel().view(np.uint32))
    return int(acc.view(np.int32))


@pytest.mark.parametrize("n,h,w", [(3, 16, 32), (2, 8, 10)])
def test_dma_floor_plain_keeps_its_contract(n, h, w):
    x = dma_case(n + h, n, h, w)
    og, oa, fold = dma_floor_plain(**x)
    assert torch.equal(og, x["grid"]) and og.data_ptr() != x["grid"].data_ptr()
    assert torch.equal(oa, x["fire_age"] + 1.0) and oa.dtype == torch.float32
    assert fold.dtype == torch.int32 and fold.tolist() == [numpy_fold(x, e) for e in range(n)]
    assert moved_bytes(n, h, w) == n * h * w * 29 + n * 48


def test_dma_floor_wrapper_on_the_cpu_and_what_it_refuses():
    x = dma_case(5, 2, 8, 16)
    launches = dma_floor.launches
    got, want = dma_floor(**x), dma_floor_plain(**x)
    assert dma_floor.launches == launches
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="16"):
        dma_floor(**dma_case(6, 2, 5, 5))
    bad = dict(x, seeds=x["seeds"].to(torch.int32))
    with pytest.raises(ValueError):
        dma_floor(**bad)


def test_bench_fused_ca_runs_on_the_cpu():
    out = bench_fused_ca.run(device="cpu", size=32, envs=2, steps=2)
    assert out["size"] == 32 and out["device"] == "cpu"
    assert all(out[f"{m}_us"] is None for m in bench_fused_ca.MODES)


# --- S1, S2, S3, S5: the launch-floor family ------------------------------------------------


@pytest.mark.parametrize("table_w", floor_kernel.TABLE_WIDTHS)
@pytest.mark.parametrize("counts_w", floor_kernel.COUNT_WIDTHS)
def test_probe_floor_writes_every_slot(table_w, counts_w):
    n = 12
    table = (torch.arange(n * table_w, dtype=torch.int32).reshape(n, table_w) * 7 + 1
             if table_w else None)
    got = probe_floor(torch.zeros((n, 4, 4), dtype=torch.int8), table, counts_w=counts_w,
                      envs_per_block=4, staged=counts_w > 0 and counts_w % 4 == 0)
    assert torch.equal(got, probe_floor_plain(n, table, counts_w=counts_w)) if counts_w else (
        got is None)
    if not counts_w:
        return
    want = np.zeros((n, 4), np.int32)
    if table_w >= 6:
        want[:, :2] = table.numpy()[:, 4:6]
    else:
        want[:, 0] = 1
    np.testing.assert_array_equal(got.numpy(), want[:, :counts_w])


def test_probe_floor_refuses_what_the_kernel_does_not_take():
    grid, table = torch.zeros((6, 4, 4), dtype=torch.int8), torch.zeros((6, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="table_w"):
        probe_floor(grid, torch.zeros((6, 4), dtype=torch.int32), counts_w=4, envs_per_block=2)
    with pytest.raises(ValueError, match="counts_w"):
        probe_floor(grid, table, counts_w=2, envs_per_block=2)
    with pytest.raises(ValueError, match="16-byte"):
        probe_floor(grid, table, counts_w=1, envs_per_block=2, staged=True)
    with pytest.raises(ValueError, match="grid or a table"):
        probe_floor(None, None, counts_w=4, envs_per_block=2)
    assert probe_floor(None, table, counts_w=4, envs_per_block=3).shape == (6, 4)


def test_floor_sweep_runs_on_the_cpu():
    variants = [FloorVariant("a", 8, 4, 0, 0), FloorVariant("b", 8, 4, 16, 4, staged=True),
                FloorVariant("c", 4, 2, 8, 1, grid=False)]
    rows = floor_kernel.run_variants(variants, steps=2, device="cpu", h=4, w=4)
    assert [r["label"] for r in rows] == ["a", "b", "c"]
    assert [r["bytes"] for r in rows] == [0, 8 * 4 * 20, 4 * 4 * 9]
    assert [r["max_abs_err"] for r in rows] == [0, 0, 0]


def _fake_sessions(monkeypatch, sessions):
    """Make ``timing.time_launches`` read ``sessions`` as the profiler's
    kernel events, one per profiled call (the warm-up's first), with no
    card: a list of µs is one kernel "k"'s events, a dict maps names to
    them."""
    left = [s if isinstance(s, dict) else ({"k": s} if s else {}) for s in sessions]
    monkeypatch.setattr(timing.torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(timing, "kernel_durations_us", lambda run, kernel: left.pop(0))
    monkeypatch.setattr(timing.time, "sleep", lambda seconds: None)  # the pause between tries
    return left


@pytest.mark.parametrize("sessions, device_us, seen", [
    ([[9.0], [2.0] * 4, [3.0] * 4, [5.0] * 4], 3.0, [4, 4, 4]),  # median of the three
    ([[9.0], [2.0] * 4, [1.0], [4.0] * 3, [5.0] * 4], 4.0, [4, 3, 4]),  # 1 of 4 made again
    ([[9.0], [9.0] * 5, [2.0] * 4, [3.0] * 4, [4.0] * 4], 3.0, [4, 4, 4]),  # 5 of 4 too
    ([[9.0], [], [1.0], [2.0, 2.0], [3.0] * 4, [1.0] * 4], 2.0, [2, 4, 4]),  # half is enough
    ([[], [9.0], [2.0] * 4, [3.0] * 4, [5.0] * 4], 3.0, [4, 4, 4]),  # a warm-up made again
])
def test_time_launches_keeps_whole_sessions_and_takes_the_median(monkeypatch, sessions,
                                                                  device_us, seen):
    left = _fake_sessions(monkeypatch, sessions)
    calls = []
    t = timing.time_launches(lambda: calls.append(1), 4, "k")
    assert (t["device_us"], t["seen"], t["launches"], left) == (device_us, seen, 4, [])
    assert t["kernels"] == {"k": device_us} and t["host_us"] >= 0
    assert len(calls) == 3  # a host-timed call per rep (the profiled calls are faked)


def test_time_launches_adds_the_kernels_of_one_call(monkeypatch):
    """Two device kernels per call (K1's light and CA passes): device µs per
    call is the sum of each kernel's own mean, so a session that lost more of
    one kernel's events than the other's reads the same; each kernel needs
    half of its launches, and a session without one of them is made again."""
    two = {"light": [1.0] * 4, "band": [5.0] * 4}
    _fake_sessions(monkeypatch, [two,
                                 {"light": [1.0] * 4, "band": [5.0] * 2},
                                 {"light": [1.0] * 4},  # the band kernel's events lost
                                 {"light": [1.0, 3.0], "band": [4.0] * 4},
                                 {"light": [1.0] * 4, "band": [1.0]},  # 1 of 4
                                 {"light": [1.0] * 4, "band": [7.0] * 4}])
    t = timing.time_launches(lambda: None, 4, "k")
    assert (t["device_us"], t["seen"]) == (6.0, [6, 6, 8])
    assert t["kernels"] == {"band": 5.0, "light": 1.0}


def test_time_launches_raises_when_no_session_holds(monkeypatch):
    broken = [[], [1.0], [1.0] * 9]  # none, 1 of 4, 9 of 4
    tries = timing.SESSION_TRIES
    _fake_sessions(monkeypatch, [[9.0], [1.0] * 4] + (broken * tries)[:tries])
    with pytest.raises(RuntimeError, match=f"in each of {tries} sessions"):
        timing.time_launches(lambda: None, 4, "k")
    _fake_sessions(monkeypatch, [[]] * tries)
    with pytest.raises(RuntimeError, match=f"in {tries} warm-up"):
        timing.time_launches(lambda: None, 4, "k")


@pytest.mark.parametrize("name", ["exp_counts_out", "exp_launch_floor", "exp_kernel_overhead",
                                  "exp_floor"])
def test_floor_entry_points_use_the_scripts_sizes(name):
    mod = importlib.import_module(f"gymca_torch.probes.{name}")
    assert all(v.n in (512, 4096) for v in mod.VARIANTS)
    assert mod.STEPS == (120 if name in ("exp_launch_floor", "exp_kernel_overhead") else 1000)
    for v in mod.VARIANTS:  # every configuration the card will be asked for is valid
        assert v.table_w in floor_kernel.TABLE_WIDTHS and v.counts_w in floor_kernel.COUNT_WIDTHS
        assert not v.staged or (v.envs_per_block * v.counts_w) % 4 == 0


# --- every entry point asks for the card -------------------------------------------------


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_ask_for_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"gymca_torch.probes.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.run()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])


# --- the kernels' input sets and the parent-tree timing ----------------------------------


@pytest.mark.parametrize("classes", ["mixed", "ca", "idle", "modify"])
def test_windy_inputs_make_the_env_classes_asked_for(classes):
    from gymca_torch.ops.windy_kernel import CLUSTER_BLOCKS
    from gymca_torch.probes import kernel_inputs as ki

    gen = torch.Generator().manual_seed(3)
    n, h, w, k = 200, 40, 64, 5
    grid, weights, params, edits, counts = ki.windy_inputs(n, h, w, torch.int8, k, gen,
                                                           device="cpu", classes=classes,
                                                           seams=True)
    do_ca, shoot = params[:, 0] > 0, params[:, 3] > 0
    assert set(grid.unique().tolist()) <= set(ki.WINDY_CELLS)
    assert {"ca": bool(do_ca.all()), "idle": not (do_ca | shoot).any(),
            "modify": not do_ca.any() and bool(shoot.any()),
            "mixed": bool(do_ca.any() and (~do_ca & shoot).any() and (~do_ca & ~shoot).any())
            }[classes]
    band = -(-h // CLUSTER_BLOCKS)
    rows = torch.cat([params[:, 1], (edits & 0xFFFF).flatten()])
    assert bool(((rows % band == 0) | (rows % band == band - 1)).all())  # on band seams
    assert bool(((edits >> 16) < w).all()) and bool((counts <= k).all())


def test_alexandridis_input_layouts_put_fire_where_they_say():
    from gymca_torch.probes import kernel_inputs as ki

    gen = torch.Generator().manual_seed(4)
    fire = {lay: ki.alexandridis_inputs(2, 128, 256, gen, device="cpu", layout=lay)[0]["grid"] == 2
            for lay in ki.K2_LAYOUTS}
    r, c = torch.arange(128)[:, None], torch.arange(256)[None, :]
    edge = (r % 32 == 0) | (r % 32 == 31) | (c % 64 == 0) | (c % 64 == 63)
    assert fire["tile_edges"].any() and not (fire["tile_edges"] & ~edge).any()
    assert not (fire["checker_tiles"] & ((r // 32 + c // 64) % 2 == 1)).any()
    assert fire["checker_tiles"].any()
    # tile (1, 1), rows 32-63 and columns 64-127: no fire inside, fire in its halo
    halo = fire["halo_only"][:, 31:65, 63:129]
    assert not halo[:, 1:-1, 1:-1].any() and halo[:, 0].all() and halo[:, :, 0].all()
    assert fire["all_fire"].all() and not fire["no_fire"].any()


def test_k1_work_counts_the_env_classes():
    from gymca_torch.probes import kernel_inputs as ki

    grid = torch.zeros((4, 8, 32), dtype=torch.int8)
    params = torch.tensor([[1, 0, 0, 1], [0, 1, 1, 1], [0, 0, 0, 0], [1, 2, 2, 0]],
                          dtype=torch.int32)
    counts = torch.tensor([3, 9, 9, 7], dtype=torch.int32)
    moved, ops, n_ca, n_mod, n_edits = ki.k1_work(grid, params, counts, 5)
    assert (n_ca, n_mod, n_edits) == (2, 1, 3 + 5)
    assert moved == 4 * 28 + 2 * (36 + 2 * 8 * 32) + 4 * 8 + 2
    assert ops == 2 * 8 * 32 * ki.OPS_PER_CELL


def test_ab_parent_asks_for_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from gymca_torch.probes import ab_parent

    with pytest.raises(RuntimeError, match="card"):
        ab_parent.main(["--parent", str(tmp_path)])


def test_ab_parent_loads_a_tree_beside_this_one(tmp_path):
    """``tree_wrappers`` on a copy of this tree: the wrappers come from the
    copy's files, this process's modules are back in place afterwards, and
    on CPU tensors the copy's wrappers give what this tree's give."""
    import shutil
    import sys
    from pathlib import Path

    import gymca_torch.ops.windy_kernel as wk
    from gymca_torch.probes import ab_parent
    from gymca_torch.probes import kernel_inputs as ki

    with pytest.raises(FileNotFoundError):
        ab_parent.tree_wrappers(tmp_path)
    here = Path(ak.__file__).parents[1]
    shutil.copytree(here, tmp_path / "gymca_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    before = dict(sys.modules)
    fns = ab_parent.tree_wrappers(tmp_path)
    assert {k: m for k, m in sys.modules.items() if k.startswith("gymca_torch")} == \
        {k: m for k, m in before.items() if k.startswith("gymca_torch")}
    assert str(tmp_path) not in sys.path
    for name, fn in fns.items():
        assert Path(fn.__globals__["__file__"]).is_relative_to(tmp_path), name
    assert fns["K1"] is not wk.windy_fused_step and fns["K2"] is fns["K3"]

    gen = torch.Generator().manual_seed(3)
    inputs = ki.windy_inputs(6, 16, 32, torch.int8, 4, gen, device="cpu")
    assert ab_parent.k1_err(fns["K1"], inputs) == 0
    x, kw = ki.alexandridis_inputs(2, 16, 24, gen, device="cpu")
    assert ab_parent.k2_err(fns["K2"], x, kw) == 0
    empty, tree, fire = ki.WINDY_CELLS
    got = fns["K1"](inputs[0].clone(), *inputs[1:], empty=empty, tree=tree, fire=fire)
    want = wk.windy_fused_step(inputs[0].clone(), *inputs[1:], empty=empty, tree=tree,
                               fire=fire)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
