"""Pinecone spotting in the port against the JAX package: ``rng.normal`` and
``rng.poisson``, ``AlexandridisCA._pinecone_spread`` and ``update`` with
pinecones, and the Advanced env with pinecones.

Inputs are made with numpy from a seed and handed to both packages.  Every
comparison is bit for bit (tolerance 0): the draws follow ``jax.random``'s
key chain and XLA's CPU rounding, and the landings follow XLA's CPU scatter,
where the last of several entries landing on one cell decides it, lit or
not.  The JAX operator runs under ``jax.jit(jax.vmap(...))``, as the env
runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax._src.lax import special as jax_special

from gymca_torch import rng
from gymca_torch.envs.terrain import get_winds
from gymca_torch.ops import alexandridis as talex
from gymca_tpu.envs.terrain import get_winds as jax_get_winds
from gymca_tpu.ops import alexandridis as jalex
from test_torch_advanced import JEnv, assert_same, port_env
from test_torch_alexandridis import port_contexts

EMPTY, TREE, FIRE = 0, 1, 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jkeys(kd):
    return jax.vmap(jax.random.wrap_key_data)(jnp.asarray(kd))


def tkeys(kd):
    return torch.tensor(np.asarray(kd).astype(np.int64))


# --- rng.normal and rng.poisson -----------------------------------------------------------


_NORMAL_LO = np.nextafter(np.float32(-1), np.float32(0))


@jax.jit
def jax_normal_from_bits(bits):
    """``random.py::_normal_real`` from its 32 random bits per element: the
    body of ``_uniform`` on ``[nextafter(-1, 0), 1)``, then ``sqrt(2) *
    erf_inv``, compiled as ``jax.random.normal`` compiles them."""
    fb = lax.bitwise_or(lax.shift_right_logical(bits, jnp.uint32(9)), jnp.uint32(0x3F800000))
    floats = lax.bitcast_convert_type(fb, jnp.float32) - jnp.float32(1)
    u = lax.max(_NORMAL_LO, floats * (jnp.float32(1) - _NORMAL_LO) + _NORMAL_LO)
    return lax.mul(np.array(np.sqrt(2), np.float32), jax_special.erf_inv(u))


def test_normal_on_every_uniform_value():
    """``rng.normal``'s transform equals JAX's on all 2**23 values the uniform
    draw takes (the 23 mantissa bits it keeps): 0 mismatches."""
    chunks = np.arange(2**23, dtype=np.uint32).reshape(4, -1)
    bad = 0
    for mantissas in chunks:
        bits = mantissas << 9
        want = np.asarray(jax_normal_from_bits(bits))
        got = rng._normal_from_bits(torch.from_numpy(bits.astype(np.int64))).numpy()
        bad += int((got.view(np.uint32) != want.view(np.uint32)).sum())
    assert bad == 0


@pytest.mark.parametrize("seed,shape", [(0, (64, 64)), (3, (7, 13)), (11, (1000,)), (5, ())])
def test_normal_equals_jax(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    got = rng.normal(rng.key(seed, device="cpu"), shape).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_normal_batched_keys_equal_vmap():
    kd = np.asarray(jax.random.key_data(jax.random.split(jax.random.key(5), 4)))
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (32, 32)))(jkeys(kd)))
    got = rng.normal(tkeys(kd), (32, 32)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed,shape", [(0, (64, 64)), (3, (7, 13)), (11, (1000,))])
def test_poisson_equals_jax(seed, shape):
    """Unclamped, and clamped at 1, 3 and 5 (``min(poisson, m)`` from exactly
    ``m`` rounds)."""
    want = np.asarray(jax.random.poisson(jax.random.key(seed), 1.0, shape))
    key = rng.key(seed, device="cpu")
    got = rng.poisson(key, 1.0, shape)
    assert got.dtype == torch.int32 and want.max() > 3
    np.testing.assert_array_equal(got.numpy(), want)
    for m in (1, 3, 5):
        np.testing.assert_array_equal(rng.poisson(key, 1.0, shape, max_count=m).numpy(),
                                      np.minimum(want, m), err_msg=str(m))


def test_poisson_batched_keys_equal_vmap():
    kd = np.asarray(jax.random.key_data(jax.random.split(jax.random.key(9), 3)))
    want = np.asarray(jax.vmap(lambda k: jax.random.poisson(k, 1.0, (32, 32)))(jkeys(kd)))
    np.testing.assert_array_equal(rng.poisson(tkeys(kd), 1.0, (32, 32)).numpy(), want)
    np.testing.assert_array_equal(rng.poisson(tkeys(kd), 1.0, (32, 32), max_count=5).numpy(),
                                  np.minimum(want, 5))


# --- the operator -------------------------------------------------------------------------


def operator_inputs(seed, n, h, w):
    r = np.random.default_rng(seed)
    grid = r.choice(np.asarray([EMPTY, TREE, TREE, TREE, FIRE, FIRE], np.int32), (n, h, w))
    per_env = {
        "wind_index": r.integers(0, 8, (n,)).astype(np.int32),
        "density": r.integers(1, 6, (n, h, w)).astype(np.int32),
        "vegetation": r.integers(1, 6, (n, h, w)).astype(np.int32),
        "slope": r.uniform(-40, 40, (n, h, w, 3, 3)).astype(np.float32),
        "fire_age": r.choice(np.asarray([0.0, 1.0, 2.0, 60.0], np.float32), (n, h, w)),
        "dousing_count": (r.random((n, h, w)) < 0.05).astype(np.int8),
    }
    kd = r.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    return grid, per_env, kd


def landing_stats(rows, cols, lit, w):
    """Per env of the spread's entries: the landing cells hit by more than
    one entry, those whose last entry is lit, and those where a lit entry is
    followed by a later unlit one (there the order of the scatter decides)."""
    out = []
    for r, c, l in zip(rows, cols, lit):
        at = r.astype(np.int64) * w + c
        last = {}
        lit_before_last = set()
        for i, cell in enumerate(at):
            if cell in last and l[last[cell]]:
                lit_before_last.add(cell)
            last[cell] = i
        counts = np.bincount(at)
        mixed = {cell for cell in lit_before_last if not l[last[cell]]}
        out.append(((counts > 1).sum(), sum(bool(l[i]) for i in last.values()), len(mixed)))
    return out


def test_pinecone_spread_equals_jax_with_duplicate_landings():
    """3 envs at 32² with a third of the cells burning and a thrust of 3 in
    every direction: rows, columns and lit flags of every entry, bit for
    bit.  The inputs hold many cells hit by several entries, cells whose
    last entry is lit and cells where a lit entry is followed by an unlit
    one."""
    n, h, w = 3, 32, 32
    grid, pe, kd = operator_inputs(1, n, h, w)
    ft = np.full((n, 3, 3), 3.0, np.float32)
    jca = jalex.AlexandridisCA(h, EMPTY, TREE, FIRE, enable_pinecones=True)
    tca = talex.AlexandridisCA(h, EMPTY, TREE, FIRE, enable_pinecones=True)
    spread = jax.jit(jax.vmap(lambda g, k, p, f: jca._pinecone_spread(g, k, p, f, g == FIRE)))
    want = [np.asarray(x) for x in spread(jnp.asarray(grid), jkeys(kd),
                                          {k: jnp.asarray(v) for k, v in pe.items()},
                                          jnp.asarray(ft))]
    tg = torch.tensor(grid)
    got = tca._pinecone_spread(tg, tkeys(kd), {k: torch.tensor(v) for k, v in pe.items()},
                               torch.tensor(ft), tg == FIRE)
    for name, g, x in zip(("rows", "cols", "lit"), got, want):
        np.testing.assert_array_equal(g.numpy(), x, err_msg=name)
    for dup, last_lit, mixed in landing_stats(*want, w):
        assert dup > 100 and last_lit > 0 and mixed > 0, (dup, last_lit, mixed)


def test_update_with_pinecones_equals_jax():
    """Four chained updates of 3 envs at 32² with pinecones, thrust 3 and
    wind changes: grid, fire age and wind index bit for bit.  Pinecones
    light cells, and the result differs from what the same entries give if
    any lit entry won its cell, so the landing order is what the test
    holds."""
    n, h, w = 3, 32, 32
    grid, pe, kd = operator_inputs(2, n, h, w)
    winds, fts = jax_get_winds(True)
    twinds, _ = get_winds(True, "cpu")
    ft = np.full((8, 3, 3), 3.0, np.float32)
    jshared = {"winds": winds, "fts": jnp.asarray(ft), "p_tree": jnp.asarray(0.0),
               "p_wind_change": jnp.asarray(0.5)}
    tshared = {"winds": twinds, "fts": torch.tensor(ft), "p_tree": torch.tensor(0.0),
               "p_wind_change": torch.tensor(0.5)}
    jca = jalex.AlexandridisCA(h, EMPTY, TREE, FIRE, enable_pinecones=True, static_p_tree=0.0)
    tca = talex.AlexandridisCA(h, EMPTY, TREE, FIRE, enable_pinecones=True, static_p_tree=0.0)
    upd = jax.jit(jax.vmap(lambda g, p, k: jca(g, None, (p, jshared), k)))

    landed = []
    real_land = tca._land_pinecones

    def land(grid, fire_age, rows, cols, lit, ages):
        out = real_land(grid, fire_age, rows, cols, lit, ages)
        any_lit = torch.zeros(grid.numel(), dtype=torch.bool)
        any_lit[(rows.long() * w + cols + torch.arange(n)[:, None] * h * w)[lit]] = True
        landed.append((int((out[0] != grid).sum()),
                       bool((any_lit.reshape(grid.shape) != (out[0] != grid)).any())))
        return out

    tca._land_pinecones = land
    jg, tg = jnp.asarray(grid), torch.tensor(grid)
    jp = {k: jnp.asarray(v) for k, v in pe.items()}
    tp = {k: torch.tensor(v) for k, v in pe.items()}
    jk, tk = jkeys(kd), tkeys(kd)
    for step in range(4):
        jg, (jp, _) = upd(jg, jp, jk)
        tg, (tp, _) = tca(tg, None, (tp, tshared), tk)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg), err_msg=str(step))
        np.testing.assert_array_equal(tp["fire_age"].numpy(), np.asarray(jp["fire_age"]))
        np.testing.assert_array_equal(tp["wind_index"].numpy(), np.asarray(jp["wind_index"]))
        jk = jax.vmap(lambda k: jax.random.fold_in(k, step))(jk)
        tk = rng.fold_in(tk, step)
    assert sum(lights for lights, _ in landed) > 0
    assert any(order_matters for _, order_matters in landed)


# --- tests/test_alexandridis.py::TestPinecones (:146-190) on the port ----------------------


def burning_tree_grid(h):
    grid = torch.full((1, h, h), TREE, dtype=torch.int32)
    grid[0, 8, 8] = FIRE
    return grid


class TestPinecones:
    def test_pinecone_mode_runs(self):
        ca = talex.AlexandridisCA(16, EMPTY, TREE, FIRE, enable_pinecones=True)
        per_env, shared = port_contexts(16, 16)
        per_env["fire_age"] = torch.zeros((1, 16, 16))
        per_env["fire_age"][0, 8, 8] = 100.0
        new_grid, _ = ca(burning_tree_grid(16), None, (per_env, shared),
                         rng.key(42, device="cpu")[None])
        assert new_grid.shape == (1, 16, 16)

    def test_zero_thrust_lands_on_source(self):
        """ft == 0: every ember lands on its own (burning) cell, so none
        lights a tree."""
        ca = talex.AlexandridisCA(16, EMPTY, TREE, FIRE, enable_pinecones=True)
        grid = burning_tree_grid(16)
        per_env, _ = port_contexts(16, 16)
        _, _, lit = ca._pinecone_spread(grid, rng.key(42, device="cpu")[None], per_env,
                                        torch.zeros((1, 3, 3)), grid == FIRE)
        assert int(lit.sum()) == 0

    def test_direction_wind_pairing(self):
        """Only the ft cell paired with compass East (drow=+1, dcol=0) has a
        thrust, so every lit ember stays in the fire cell's column and lands
        on a tree, not on the fire."""
        ca = talex.AlexandridisCA(32, EMPTY, TREE, FIRE, enable_pinecones=True)
        grid = burning_tree_grid(32)
        per_env, _ = port_contexts(32, 32)
        ft = torch.zeros((1, 3, 3))
        ft[0, 0, 0] = 4.0  # East's thrust cell
        lit_rows, lit_cols = [], []
        key = rng.key(42, device="cpu")
        for i in range(30):
            rows, cols, lit = ca._pinecone_spread(grid, rng.fold_in(key, i)[None], per_env, ft,
                                                  grid == FIRE)
            lit_rows.append(rows[lit])
            lit_cols.append(cols[lit])
        lit_rows, lit_cols = torch.cat(lit_rows), torch.cat(lit_cols)
        assert lit_rows.numel() > 0, "eastward flights should ignite some trees"
        assert bool((lit_cols == 8).all()), "East flights must preserve the column"
        assert bool((lit_rows != 8).all()), "lit embers landed on trees, not the fire"


# --- the Advanced env -------------------------------------------------------------------


def test_advanced_env_with_pinecones_equals_jax(monkeypatch):
    """2 envs at 32², 10 steps of ``stateless_step`` + ``conditional_reset``
    with pinecones on the XLA path (the JAX package's only path for them),
    every leaf bit for bit.  A 10 x 10 block of trees is set burning first
    on both sides, so embers fly and are lit."""
    jenv = JEnv(32, 32, key=jax.random.key(2), num_envs=2, enable_pinecones=True)
    tenv = port_env(jenv, enable_pinecones=True)
    assert not tenv.use_fused_ca and tenv.ca.enable_pinecones
    lit_total = []
    real_spread = talex.AlexandridisCA._pinecone_spread

    def spread(self, *args):
        out = real_spread(self, *args)
        lit_total.append(int(out[2].sum()))
        return out

    monkeypatch.setattr(talex.AlexandridisCA, "_pinecone_spread", spread)

    def ignite(obs, block):
        rgb, ctx = obs
        ctx, per_env = dict(ctx), dict(ctx["per_env_context"])
        per_env["true_grid"] = block(per_env["true_grid"])
        ctx["per_env_context"] = per_env
        return rgb, ctx

    def jax_block(tg):
        sub = tg[:, 10:20, 10:20]
        return tg.at[:, 10:20, 10:20].set(jnp.where(sub == TREE, FIRE, sub))

    def torch_block(tg):
        tg = tg.clone()
        sub = tg[:, 10:20, 10:20]
        tg[:, 10:20, 10:20] = torch.where(sub == TREE, FIRE, sub)
        return tg

    j_obs, j_info = jenv.reset()
    t_obs, t_info = tenv.reset()
    assert_same("reset", (t_obs, t_info), (j_obs, j_info))
    j_obs, t_obs = ignite(j_obs, jax_block), ignite(t_obs, torch_block)
    r = np.random.default_rng(4)
    for i in range(10):
        a = np.stack([r.integers(0, 9, 2), r.integers(0, 2, 2), np.zeros(2, int)], -1)
        ja, ta = jnp.asarray(a, jnp.int32), torch.tensor(a, dtype=torch.int32)
        js, ts = jenv.stateless_step(ja, j_obs, j_info), tenv.stateless_step(ta, t_obs, t_info)
        assert_same(f"step {i}", ts, js)
        jr, tr = jenv.conditional_reset(js, ja), tenv.conditional_reset(ts, ta)
        assert_same(f"reset {i}", tr, jr)
        j_obs, j_info, t_obs, t_info = jr[0], jr[4], tr[0], tr[4]
    assert len(lit_total) == 10 and sum(lit_total) > 0
