"""The Alexandridis CA of the port against the JAX package: the box-sum
stencils, ``AlexandridisCA`` (the XLA path), the fused kernel's plain
version (K2/K3) and its draws.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX kernel runs in Pallas interpret mode, where ``prng_random_bits`` is a
zero stub; the port's draws are replaced by zeros for those comparisons
(monkeypatched here, no knob in the port).  The CUDA kernel itself is held
to the plain version in ``tests/test_torch_gpu.py``
(``test_alexandridis_kernel_matches_plain_on_the_card``, its tile layouts
and the recorded launches of every path), and its draws to the XLA path's
statistics by ``test_fused_ca_statistics_match_the_xla_path_on_the_card``.
Tolerances: 0 unless a test states otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gymca_torch.ops.alexandridis_kernel as ak
from gymca_torch import interop, rng
from gymca_torch.envs.terrain import get_winds
from gymca_torch.ops import alexandridis as talex
from gymca_torch.ops import stencil as tstencil
from gymca_tpu.envs.terrain import get_winds as jax_get_winds
from gymca_tpu.ops import alexandridis as jalex
from gymca_tpu.ops import stencil as jstencil
from gymca_tpu.ops.pallas_alexandridis import alexandridis_fused_step as jax_fused_step

EMPTY, TREE, FIRE = 0, 1, 2
COEFFS = jstencil.telescoped_box_coeffs(jalex.burn_kernel_layer_weights(2))
KW = dict(empty=EMPTY, tree=TREE, fire=FIRE, layer_coeffs=COEFFS, dousing_border=0.01,
          dousing_inner=0.1, fire_age_min=48, fire_age_max=56)


def bf16_pair(x):
    """float32 numpy -> the same bfloat16 values as a jnp array and a torch
    tensor (JAX rounds, the bits cross through ``interop``)."""
    j = jnp.asarray(np.asarray(x, np.float32)).astype(jnp.bfloat16)
    return j, interop._bf16_from_numpy(np.asarray(j), "cpu")


# --- stencil -----------------------------------------------------------------------


@pytest.mark.parametrize("h,w", [(24, 40), (128, 136)])  # below and above the 128 cut
def test_multi_box_sums_equal_jax(h, w):
    x = (np.random.default_rng(h).random((2, h, w)) < 0.3).astype(np.float32)
    radii = (1, 2, 4, 6)
    want = jstencil.multi_box_sums(jnp.asarray(x), radii)
    got = tstencil.multi_box_sums(torch.from_numpy(x), radii)
    for r in radii:
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want[r]))


@pytest.mark.parametrize("h,w", [(24, 40), (128, 136)])
def test_ring_kernel_filter_within_two_ulp_of_jax(h, w):
    """Within 2 float32 ulp: XLA may fuse the multiply-adds of the ring sum."""
    x = (np.random.default_rng(h + 1).random((2, h, w)) < 0.3).astype(np.float32)
    weights = jalex.burn_kernel_layer_weights(6)
    want = np.asarray(jstencil.ring_kernel_filter(jnp.asarray(x), weights))
    got = tstencil.ring_kernel_filter(torch.from_numpy(x), weights).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=2)


def test_correlate2d_and_box_coefficients():
    """``correlate2d`` is the dense oracle: it agrees with JAX's within 1e-6
    (both sum the window in their own order) and with the ring form."""
    x = (np.random.default_rng(3).random((2, 20, 24)) < 0.4).astype(np.float32)
    k = np.array(jalex.build_burn_kernel(3))
    want = np.asarray(jstencil.correlate2d(jnp.asarray(x), jnp.asarray(k)))
    got = tstencil.correlate2d(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    ring = tstencil.ring_kernel_filter(torch.from_numpy(x),
                                       talex.burn_kernel_layer_weights(3)).numpy()
    np.testing.assert_allclose(ring, got, rtol=0, atol=1e-6)
    for n in (1, 2, 6, 8):
        w = jalex.burn_kernel_layer_weights(n)
        assert tstencil.telescoped_box_coeffs(w) == jstencil.telescoped_box_coeffs(w)


# --- constants and precomputed terrain factors ------------------------------------------


def test_tables_and_kernels_equal_jax():
    for mine, theirs in ((talex.VEG_PROBS, jalex.VEG_PROBS), (talex.DEN_PROBS, jalex.DEN_PROBS)):
        np.testing.assert_array_equal(np.asarray(mine, np.float32), np.asarray(theirs))
    assert talex.SLOPE_COEFF == jalex.SLOPE_COEFF
    for radius in (1, 2, 3, 6):
        assert talex.burn_kernel_layer_weights(radius) == jalex.burn_kernel_layer_weights(radius)
        np.testing.assert_array_equal(talex.build_burn_kernel(radius, "cpu").numpy(),
                                      np.asarray(jalex.build_burn_kernel(radius)))
    np.testing.assert_array_equal(talex.build_dousing_weights(84, "cpu").numpy(),
                                  np.asarray(jalex.build_dousing_weights(84)))


def test_veg_den_factor_equals_jax():
    r = np.random.default_rng(4)
    veg, den = r.integers(0, 7, (2, 16, 24)), r.integers(0, 7, (2, 16, 24))
    want = jalex.AlexandridisCA.precompute_veg_den_factor(jnp.asarray(veg), jnp.asarray(den))
    got = talex.AlexandridisCA.precompute_veg_den_factor(torch.from_numpy(veg),
                                                         torch.from_numpy(den))
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(want).view(np.uint16))


def test_exp_slope_within_one_bf16_ulp(record_property):
    """Bit for bit (the name is from when it was within one bf16 ulp): the
    port's exp rounds as XLA's CPU exp does; the count that differ is
    recorded (0)."""
    slope = np.random.default_rng(5).uniform(-60, 60, (2, 16, 24, 3, 3)).astype(np.float32)
    want = np.asarray(jalex.AlexandridisCA.precompute_exp_slope(jnp.asarray(slope)))
    got = talex.AlexandridisCA.precompute_exp_slope(torch.from_numpy(slope))
    assert got.shape == (2, 3, 3, 16, 24) and got.is_contiguous()
    diff = np.abs(got.view(torch.int16).numpy().astype(np.int32)
                  - want.view(np.int16).astype(np.int32))
    record_property("exp_slope_elements_differing", int((diff > 0).sum()))
    assert diff.max() == 0


# --- AlexandridisCA, the XLA path ---------------------------------------------------------


def ca_inputs(seed, h, w, direct):
    """One env's grid and context as numpy, for both packages."""
    r = np.random.default_rng(seed)
    grid = r.choice(np.asarray([EMPTY, TREE, TREE, TREE, FIRE], np.int32), (h, w))
    per_env = {
        "wind_index": np.int32(r.integers(0, 8)),
        "density": r.integers(1, 6, (h, w)).astype(np.int32),
        "vegetation": r.integers(1, 6, (h, w)).astype(np.int32),
        "slope": r.uniform(-40, 40, (h, w, 3, 3)).astype(np.float32),
        "fire_age": r.choice(np.asarray([0.0, 1.0, 1.5, 2.0, 60.0], np.float32), (h, w)),
        "dousing_count": (r.random((h, w)) < 0.05).astype(np.int8),
    }
    if not direct:  # the env's precomputed factors, in bfloat16
        ca = jalex.AlexandridisCA
        per_env["exp_slope"] = np.asarray(ca.precompute_exp_slope(jnp.asarray(per_env["slope"])))
        per_env["veg_den_factor"] = np.asarray(ca.precompute_veg_den_factor(
            jnp.asarray(per_env["vegetation"]), jnp.asarray(per_env["density"])))
    return grid, per_env


@pytest.mark.parametrize("direct", [True, False], ids=["direct", "precomputed"])
def test_ca_update_equals_jax(direct):
    """Three chained updates of one env at 32x32 from the same key: grid,
    fire age and wind index bit for bit."""
    h = w = 32
    grid, pe = ca_inputs(6, h, w, direct)
    jca = jalex.AlexandridisCA(h, EMPTY, TREE, FIRE, static_p_tree=0.0)
    tca = talex.AlexandridisCA(h, EMPTY, TREE, FIRE, static_p_tree=0.0)
    winds, fts = jax_get_winds(True)
    jshared = {"winds": winds, "fts": fts, "p_tree": jnp.asarray(0.0),
               "p_wind_change": jnp.asarray(0.5)}
    twinds, tfts = get_winds(True, "cpu")
    tshared = {"winds": twinds, "fts": tfts, "p_tree": torch.tensor(0.0),
               "p_wind_change": torch.tensor(0.5)}
    jpe = {k: jnp.asarray(v) for k, v in pe.items()}
    tpe = {k: (interop._bf16_from_numpy(v, "cpu")[None] if k in ("exp_slope", "veg_den_factor")
               else torch.tensor(v)[None]) for k, v in pe.items()}
    jgrid, tgrid = jnp.asarray(grid), torch.tensor(grid)[None]
    kd = np.asarray([[7, 123456789]], np.uint32)
    jkey, tkey = jax.random.wrap_key_data(jnp.asarray(kd[0])), torch.tensor(kd.astype(np.int64))
    for step in range(3):
        jgrid, (jpe, _) = jca(jgrid, None, (jpe, jshared), jkey)
        tgrid, (tpe, _) = tca(tgrid, None, (tpe, tshared), tkey)
        np.testing.assert_array_equal(tgrid[0].numpy(), np.asarray(jgrid), err_msg=str(step))
        np.testing.assert_array_equal(tpe["fire_age"][0].numpy(), np.asarray(jpe["fire_age"]))
        assert int(tpe["wind_index"][0]) == int(jpe["wind_index"])
        jkey, tkey = jax.random.fold_in(jkey, step), rng.fold_in(tkey, step)
    assert (np.asarray(jgrid) == FIRE).sum() > 0


def port_contexts(h, w, dousing=None):
    """The port's counterpart of ``tests/test_alexandridis.py::make_contexts``
    for one env, batched."""
    winds, fts = get_winds(True, "cpu")
    per_env = {
        "wind_index": torch.zeros((1,), dtype=torch.int32),
        "density": torch.full((1, h, w), 3, dtype=torch.int32),
        "vegetation": torch.full((1, h, w), 3, dtype=torch.int32),
        "altitude": torch.zeros((1, h, w)),
        "slope": torch.zeros((1, h, w, 3, 3)),
        "fire_age": torch.full((1, h, w), 100.0),
        "dousing_count": (torch.zeros((1, h, w), dtype=torch.int32) if dousing is None
                          else dousing),
    }
    shared = {"winds": winds, "fts": fts, "p_fire": torch.tensor(0.00033),
              "p_tree": torch.tensor(0.0), "p_wind_change": torch.tensor(0.0)}
    return per_env, shared


def one_fire(h, w, fill):
    grid = torch.full((1, h, w), fill, dtype=torch.int32)
    grid[0, h // 2, w // 2] = FIRE
    return grid


def run_ca(ca, grid, per_env, shared, steps, seed=42):
    keys = rng.split(rng.key(seed, device="cpu"), steps)
    counts = []
    for i in range(steps):
        grid, (per_env, _) = ca(grid, None, (per_env, shared), keys[i][None])
        counts.append(int((grid == FIRE).sum()))
    return grid, per_env, counts


class TestRules:
    """``tests/test_alexandridis.py``'s rule tests on the port."""

    def test_burnout_at_age_one(self):
        ca = talex.AlexandridisCA(16, EMPTY, TREE, FIRE)
        per_env, shared = port_contexts(16, 16)
        per_env["fire_age"] = torch.zeros((1, 16, 16))
        per_env["fire_age"][0, 8, 8] = 1.0
        grid, _, counts = run_ca(ca, one_fire(16, 16, EMPTY), per_env, shared, 1)
        assert int(grid[0, 8, 8]) == EMPTY and counts == [0]

    def test_no_spontaneous_fire(self):
        ca = talex.AlexandridisCA(16, EMPTY, TREE, FIRE)
        grid = torch.full((1, 16, 16), TREE, dtype=torch.int32)
        new, _, _ = run_ca(ca, grid, *port_contexts(16, 16), 1)
        assert torch.equal(new, grid)

    def test_fire_spreads_eventually(self):
        ca = talex.AlexandridisCA(16, EMPTY, TREE, FIRE)
        _, _, counts = run_ca(ca, one_fire(16, 16, TREE), *port_contexts(16, 16), 60)
        assert counts[-1] > 1

    def test_dousing_suppresses_spread(self):
        ca = talex.AlexandridisCA(16, EMPTY, TREE, FIRE)
        doused = torch.ones((1, 16, 16), dtype=torch.int32)
        _, _, counts = run_ca(ca, one_fire(16, 16, TREE), *port_contexts(16, 16, doused), 30)
        assert max(counts) <= 1

    def test_growth_with_p_tree_one(self):
        ca = talex.AlexandridisCA(16, EMPTY, TREE, FIRE)
        per_env, shared = port_contexts(16, 16)
        shared["p_tree"] = torch.tensor(1.0)
        grid, _, _ = run_ca(ca, torch.zeros((1, 16, 16), dtype=torch.int32), per_env,
                            shared, 1)
        assert bool((grid == TREE).all())

    def test_wind_rotation_when_forced(self):
        ca = talex.AlexandridisCA(16, EMPTY, TREE, FIRE)
        per_env, shared = port_contexts(16, 16)
        shared["p_wind_change"] = torch.tensor(1.0)
        _, per_env, _ = run_ca(ca, torch.zeros((1, 16, 16), dtype=torch.int32), per_env,
                               shared, 1)
        assert int(per_env["wind_index"][0]) != 0

    def test_new_fire_gets_age_in_range(self):
        ca = talex.AlexandridisCA(16, EMPTY, TREE, FIRE)
        grid = torch.full((1, 16, 16), FIRE, dtype=torch.int32)
        grid[0, 8, 8] = TREE
        per_env, shared = port_contexts(16, 16)
        per_env["fire_age"] = torch.full((1, 16, 16), 50.0)
        for i in range(20):
            new, (pe, _) = ca(grid, None, (per_env, shared),
                              rng.fold_in(rng.key(42, device="cpu"), i)[None])
            if int(new[0, 8, 8]) == FIRE:
                assert ca.fire_age_min <= float(pe["fire_age"][0, 8, 8]) <= ca.fire_age_max
                return
        pytest.fail("a tree surrounded by fire should ignite within 20 tries")

    def test_pinecones_wait_for_a_later_slice(self):
        """Pinecone spotting is ported now (the name is from when it raised):
        the operator builds and steps one burning env
        (``tests/test_alexandridis.py::TestPinecones::test_pinecone_mode_runs``;
        the JAX package parity is in ``tests/test_torch_pinecones.py``)."""
        ca = talex.AlexandridisCA(16, EMPTY, TREE, FIRE, enable_pinecones=True)
        per_env, shared = port_contexts(16, 16)
        per_env["fire_age"] = torch.zeros((1, 16, 16))
        per_env["fire_age"][0, 8, 8] = 100.0
        grid, _, _ = run_ca(ca, one_fire(16, 16, TREE), per_env, shared, 1)
        assert grid.shape == (1, 16, 16)


# --- the fused kernel's plain version against K2/K3 in interpret mode --------------------


@pytest.fixture
def zero_draws(monkeypatch):
    """The port's draws as the Pallas interpreter's PRNG stub gives them:
    every uniform and every age word 0."""
    def draws(seeds, h, w):
        n = seeds.shape[0]
        return torch.zeros((n, h, w)), torch.zeros((n, h, w), dtype=torch.int64)

    monkeypatch.setattr(ak, "alexandridis_draws", draws)


def both(grid, age, dousing, vdf, exp_slope, wind, seeds, **jax_kw):
    """The JAX kernel (interpret mode) and the port's wrapper on the CPU on
    the same numpy inputs; asserts they agree exactly, returns the port's."""
    jv, tv = bf16_pair(vdf)
    je, te = bf16_pair(exp_slope)
    jg, ja = jax_fused_step(jnp.asarray(grid, jnp.int32), jnp.asarray(age),
                            jnp.asarray(dousing, jnp.int32), jv, je, jnp.asarray(wind),
                            jnp.asarray(seeds, jnp.int32), interpret=True, **KW, **jax_kw)
    tg, ta = ak.alexandridis_fused_step(
        torch.tensor(grid, dtype=torch.int8), torch.tensor(age, dtype=torch.float32),
        torch.tensor(dousing, dtype=torch.int8), tv, te,
        torch.tensor(wind, dtype=torch.float32), torch.tensor(seeds, dtype=torch.int64), **KW)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    return tg.numpy(), ta.numpy()


N, H, W = 2, 8, 128
SEEDS = np.asarray([[3, 17], [5, 23]])


def rule_case(grid, age=None, dousing=None, vdf=2.0, wind=100.0):
    age = age if age is not None else np.where(grid == FIRE, 50.0, 0.0).astype(np.float32)
    dousing = dousing if dousing is not None else np.zeros_like(grid)
    return both(grid, age, dousing, np.full((N, H, W), vdf), np.ones((N, 3, 3, H, W)),
                np.full((N, 8), wind, np.float32), SEEDS)


def trees_with_fires(fill=TREE):
    grid = np.full((N, H, W), fill, np.int32)
    grid[0, 4, 60] = FIRE
    grid[1, 0, 127] = FIRE  # a corner: three neighbours
    return grid


@pytest.mark.usefixtures("zero_draws")
class TestKernelRuleAgainstJax:
    """``tests/test_pallas_alexandridis.py``'s deterministic tests, on both."""

    def test_certain_ignition_moore_neighbors(self):
        grid = trees_with_fires()
        ng, na = rule_case(grid)
        assert (ng[0] == FIRE).sum() == 9 and (ng[1] == FIRE).sum() == 4
        new_fire = (ng == FIRE) & (grid != FIRE)
        assert (na[new_fire] == KW["fire_age_min"]).all()
        assert na[0, 4, 60] == 49.0

    def test_no_fire_fixpoint(self):
        grid = np.ones((N, H, W), np.int32)
        ng, na = rule_case(grid, age=np.zeros((N, H, W), np.float32))
        np.testing.assert_array_equal(ng, grid)
        np.testing.assert_array_equal(na, 0.0)

    def test_dousing_blocks_ignition(self):
        ng, _ = rule_case(trees_with_fires(), dousing=np.ones((N, H, W), np.int32))
        assert (ng == FIRE).sum() == 2

    def test_burnout_at_age_one(self):
        grid = trees_with_fires()
        age = np.where(grid == FIRE, 1.0, 0.0).astype(np.float32)
        ng, _ = rule_case(grid, age=age, dousing=np.ones((N, H, W), np.int32))
        assert ng[0, 4, 60] == EMPTY and ng[1, 0, 127] == EMPTY

    def test_zero_wind_no_spread(self):
        ng, _ = rule_case(trees_with_fires(), wind=0.0)
        assert (ng == FIRE).sum() == 2

    def test_empty_never_grows(self):
        ng, _ = rule_case(trees_with_fires(EMPTY))
        assert (ng == TREE).sum() == 0

    @pytest.mark.parametrize("tiled", [False, True], ids=["single_program", "tiled"])
    def test_random_inputs_with_fires_on_band_seams(self, tiled):
        """Random terrain factors, winds, dousing and ages at (1, 32, 128),
        fires on the seams of 8-row bands and at the corners, against the
        single-program branch and the tiled one (``force_tiled``,
        ``tile_band_rows=8``)."""
        r = np.random.default_rng(9)
        grid = r.choice(np.asarray([EMPTY, TREE, TREE, FIRE], np.int32), (1, 32, 128))
        for row, col in [(7, 64), (8, 70), (15, 5), (16, 9), (23, 100), (24, 101),
                         (0, 0), (31, 127)]:
            grid[0, row, col] = FIRE
        age = r.choice(np.asarray([0.5, 1.0, 1.5, 2.0, 50.0], np.float32), grid.shape)
        dousing = (r.random(grid.shape) < 0.1).astype(np.int32)
        vdf = r.uniform(0.5, 3.0, grid.shape)
        exp_slope = r.uniform(0.8, 1.25, (1, 3, 3, 32, 128))
        wind = r.uniform(0.0, 3.0, (1, 8)).astype(np.float32)
        kw = dict(force_tiled=True, tile_band_rows=8) if tiled else {}
        ng, _ = both(grid, age, dousing, vdf, exp_slope, wind, np.asarray([[3, 17]]), **kw)
        assert ((ng == FIRE) & (grid == TREE)).sum() > 0


def test_rule_with_the_xla_paths_uniforms_gives_its_grid():
    """The kernel's float order is the XLA path's: fed ``AlexandridisCA``'s
    own uniforms, the rule gives that path's grid (ages are drawn another
    way, so only the grid is compared)."""
    h = w = 32
    grid, pe = ca_inputs(10, h, w, direct=False)
    tca = talex.AlexandridisCA(h, EMPTY, TREE, FIRE, static_p_tree=0.0)
    winds, fts = get_winds(True, "cpu")
    shared = {"winds": winds, "fts": fts, "p_tree": torch.tensor(0.0),
              "p_wind_change": torch.tensor(0.0)}
    tpe = {k: (interop._bf16_from_numpy(v, "cpu")[None] if k in ("exp_slope", "veg_den_factor")
               else torch.tensor(v)[None]) for k, v in pe.items()}
    tgrid = torch.tensor(grid)[None]
    keys = torch.tensor([[11, 22]])
    want, _ = tca(tgrid, None, (tpe, shared), keys)
    u = rng.uniform(rng.split(keys, 6)[:, 0], (h, w))
    wm = winds[tpe["wind_index"].long()]
    wind_rows = torch.stack([wm[:, 1 + dr, 1 + dc] for dr, dc in tstencil.NEIGHBOR_OFFSETS], -1)
    got, _ = ak.alexandridis_rule(
        tgrid.to(torch.int8), tpe["fire_age"], tpe["dousing_count"], tpe["veg_den_factor"],
        tpe["exp_slope"], wind_rows, u, torch.zeros((1, h, w), dtype=torch.int64),
        empty=EMPTY, tree=TREE, fire=FIRE, layer_coeffs=tstencil.telescoped_box_coeffs(
            tca.burn_layer_weights), dousing_border=tca._dousing_border,
        dousing_inner=tca._dousing_inner, fire_age_min=tca.fire_age_min,
        fire_age_max=tca.fire_age_max)
    np.testing.assert_array_equal(got.numpy(), want.to(torch.int8).numpy())
    assert ((want == FIRE) & (tgrid == TREE)).sum() > 0


# --- the draws -----------------------------------------------------------------------------


def test_draws_are_threefry_of_the_flat_cell_index():
    seeds = torch.tensor([[0, 1], [2**32 - 1, 12345], [7, 2**31]])
    u, bits = ak.alexandridis_draws(seeds, 5, 7)
    assert u.shape == bits.shape == (3, 5, 7) and u.dtype == torch.float32
    for e in range(3):
        idx = torch.arange(35)
        b1, b2 = rng.threefry2x32(seeds[e, 0], seeds[e, 1], torch.zeros_like(idx), idx)
        np.testing.assert_array_equal(bits[e].reshape(-1).numpy(), b2.numpy())
        want_u = ((b1 >> 8).numpy().astype(np.float32) * np.float32(2.0**-24))
        np.testing.assert_array_equal(u[e].reshape(-1).numpy(), want_u)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def random_step_inputs(seed, n, h, w, p_fire):
    r = np.random.default_rng(seed)
    cells = r.random((n, h, w))
    grid = np.where(cells < p_fire, FIRE, np.where(cells < 0.9, TREE, EMPTY))
    _, te = bf16_pair(r.uniform(0.8, 1.25, (n, 3, 3, h, w)))
    _, tv = bf16_pair(r.uniform(0.5, 3.0, (n, h, w)))
    return dict(
        grid=torch.tensor(grid, dtype=torch.int8),
        fire_age=torch.full((n, h, w), 50.0),
        dousing=torch.tensor((r.random((n, h, w)) < 0.05).astype(np.int8)),
        vdf=tv, exp_slope=te,
        wind_rows=torch.tensor(r.uniform(0.5, 4.0, (n, 8)).astype(np.float32)),
        seeds=torch.tensor(r.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.int64)),
    )


def test_new_fires_match_their_probabilities():
    """One step at 64 envs x 16x128 with the real draws: the count of new
    fires lies within 5 sigma of sum q, sigma^2 = sum q(1 - q), where q is
    the rule's own ignition threshold on each tree."""
    x = random_step_inputs(12, 64, 16, 128, 0.03)
    kw = {k: KW[k] for k in ("layer_coeffs", "dousing_border", "dousing_inner")}
    q = ak.alexandridis_ignition(x["grid"], x["dousing"], x["vdf"], x["exp_slope"],
                                 x["wind_rows"], fire=FIRE, **kw).double().clamp(0, 1)
    tree = x["grid"] == TREE
    q = q[tree]
    new_grid, _ = ak.alexandridis_fused_step(**x, **KW)
    new_fires = int(((new_grid == FIRE) & tree).sum())
    mean, sigma = float(q.sum()), float((q * (1 - q)).sum()) ** 0.5
    assert sigma > 10, "the case must make many uncertain ignitions"
    assert abs(new_fires - mean) <= 5 * sigma, (new_fires, mean, sigma)


def test_new_ages_cover_their_range():
    x = random_step_inputs(13, 8, 16, 128, 0.5)
    x["wind_rows"] = x["wind_rows"] * 1000.0  # every tree beside a fire ignites
    new_grid, new_age = ak.alexandridis_fused_step(**x, **KW)
    ages = new_age[(new_grid == FIRE) & (x["grid"] == TREE)]
    assert set(ages.tolist()) == set(map(float, range(KW["fire_age_min"], KW["fire_age_max"])))


# --- the wrapper's contract on the CPU ------------------------------------------------------


def test_wrapper_on_cpu_is_the_plain_version_out_of_place():
    x = random_step_inputs(14, 3, 8, 24, 0.2)
    before = {k: v.clone() for k, v in x.items()}
    launches = ak.alexandridis_fused_step.launches
    g, a = ak.alexandridis_fused_step(**x, **KW)
    assert ak.alexandridis_fused_step.launches == launches  # no kernel on the CPU
    assert g.dtype == torch.int8 and a.dtype == torch.float32
    for k, v in x.items():
        assert torch.equal(v.view(torch.int16) if v.dtype == torch.bfloat16 else v,
                           before[k].view(torch.int16) if v.dtype == torch.bfloat16
                           else before[k])
    pg, pa = ak.alexandridis_fused_step_plain(**x, **KW)
    assert torch.equal(g, pg) and torch.equal(a, pa)


@pytest.mark.parametrize("bad", ["grid_dtype", "slope_shape", "seeds_dtype", "noncontig",
                                 "radius", "cell_value"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = random_step_inputs(15, 2, 8, 16, 0.2)
    kw = dict(KW)
    if bad == "grid_dtype":
        x["grid"] = x["grid"].to(torch.int32)
    elif bad == "slope_shape":
        x["exp_slope"] = x["exp_slope"][:, :2].contiguous()
    elif bad == "seeds_dtype":
        x["seeds"] = x["seeds"].to(torch.int32)
    elif bad == "noncontig":
        x["fire_age"] = x["fire_age"].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "radius":
        kw["layer_coeffs"] = (0.001,) * (ak.MAX_RADIUS + 1)
    elif bad == "cell_value":
        kw["fire"] = 200
    with pytest.raises(ValueError):
        ak.alexandridis_fused_step(**x, **kw)


# --- the work the kernel's bound counts --------------------------------------------------


@pytest.mark.parametrize("layout", ["random", "no_fire", "all_fire", "corner_fire"])
def test_work_count_against_a_numpy_count(layout):
    """``alexandridis_work`` against a cell-by-cell count: candidates (trees
    with an on-grid burning Moore neighbour), their burning directions, the
    cells within 2 of a candidate (which read dousing), and the bytes and
    operations the docstring sets per cell and candidate."""
    r = np.random.default_rng(11)
    n, h, w = 2, 9, 13
    grid = r.choice(np.asarray([EMPTY, TREE, TREE, FIRE], np.int8), (n, h, w))
    if layout == "no_fire":
        grid[grid == FIRE] = TREE
    elif layout == "all_fire":
        grid[:] = FIRE
    elif layout == "corner_fire":
        grid[:] = TREE
        grid[:, 0, 0] = grid[:, -1, -1] = FIRE
    work = ak.alexandridis_work({"grid": torch.from_numpy(grid)}, KW)
    cand = dirs = 0
    for e, i, j in np.ndindex(n, h, w):
        if grid[e, i, j] == TREE:
            k = sum(1 for di in (-1, 0, 1) for dj in (-1, 0, 1)
                    if (di or dj) and 0 <= i + di < h and 0 <= j + dj < w
                    and grid[e, i + di, j + dj] == FIRE)
            cand, dirs = cand + (k > 0), dirs + k
    is_cand = np.zeros((n, h, w), bool)
    for e, i, j in np.ndindex(n, h, w):
        is_cand[e, i, j] = grid[e, i, j] == TREE and any(
            grid[e, a, b] == FIRE for a in range(max(i - 1, 0), min(i + 2, h))
            for b in range(max(j - 1, 0), min(j + 2, w)))
    doused = sum(bool(is_cand[e, max(i - 2, 0):i + 3, max(j - 2, 0):j + 3].any())
                 for e, i, j in np.ndindex(n, h, w))
    cells, rad, burning = n * h * w, len(COEFFS), int((grid == FIRE).sum())
    if layout == "corner_fire":
        assert (cand, dirs) == (2 * 6, 2 * 6)
    if layout in ("no_fire", "all_fire"):
        assert cand == 0
    if layout in ("no_fire", "all_fire"):
        assert doused == 0
    assert (work["cells"], work["candidates"], work["candidate_directions"],
            work["doused_cells"]) == (cells, cand, dirs, doused)
    assert work["bytes"] == 10 * cells + doused + 2 * cand + 2 * dirs + 48 * n
    assert work["int_ops"] == 4 * cells + cand * (77 + 3 * (rad + 2) + 4)
    assert work["float_ops"] == cand * (2 * rad + 7) + 5 * dirs + burning
    assert work["dense_bytes"] == 29 * cells + 48 * n
    assert work["dense_int_ops"] == cells * (77 + 3 * (rad + 2) + 8)
    assert work["dense_float_ops"] == cells * (2 * rad + 47)
