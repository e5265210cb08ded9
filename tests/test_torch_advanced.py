"""The Advanced Bulldozer env of the port against the JAX package: terrain,
extensions, and the env on both CA paths.

The port's env draws its own terrain from the JAX env's key, and it equals
the JAX env's in every field, so the envs start from the same state; inputs
and actions are made with numpy from a seed.  The env on the XLA path must
match bit for bit.  On the fused path
the JAX kernel runs in Pallas interpret mode (its PRNG a zero stub) and the
port's kernel draws are replaced by zeros (monkeypatched here).  Terrain
fields that go through transcendentals are compared bit for bit too: the
port reproduces the rounding of XLA's CPU ``cos``, ``arctan`` and ``exp``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gymca_torch.ops.alexandridis_kernel as ak
import gymca_tpu.ops.pallas_alexandridis as pa
from gymca_torch import interop, rng
from gymca_torch.envs import extensions as text
from gymca_torch.envs import terrain as tterrain
from gymca_torch.envs.advanced import TERRAIN_KEYS
from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv as TEnv
from gymca_tpu.envs import extensions as jext
from gymca_tpu.envs import terrain as jterrain
from gymca_tpu.envs.advanced import AdvancedForestFireBulldozerEnv as JEnv

BF16 = ("exp_slope", "veg_den_factor")


def torch_key(jkey):
    return torch.tensor(np.asarray(jax.random.key_data(jkey)).astype(np.int64))


def bf16_ulps(got: torch.Tensor, want) -> np.ndarray:
    return np.abs(got.view(torch.int16).numpy().astype(np.int32)
                  - np.asarray(want).view(np.int16).astype(np.int32))


# --- terrain ---------------------------------------------------------------------------


@pytest.mark.parametrize("field", ["init_vegetation", "init_density"])
def test_patch_fields_equal_jax(field):
    key = jax.random.key(5)
    want = getattr(jterrain, field)(key, 24, 40, 3)
    got = getattr(tterrain, field)(torch_key(key), 24, 40, 3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_altitude_within_four_ulp():
    """Bit for bit (the name is from when it was within 4 ulp) with the JAX
    altitude jitted, as the env builds its terrain: under ``jit`` XLA folds
    ``/ 10`` into a multiply by the float32 reciprocal, which the port
    reproduces.  At 256² the hills reach radius 63, so the cosine takes
    arguments up to pi/2."""
    for seed, (h, w, n) in ((6, (24, 40, 3)), (2, (256, 256, 1))):
        key = jax.random.key(seed)
        want = np.asarray(jax.jit(lambda k: jterrain.init_altitude(k, h, w, n))(key))
        got = tterrain.init_altitude(torch_key(key), h, w, n).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.std() > 0.01


def test_slope_within_four_ulp_from_the_same_altitude():
    """Bit for bit (the name is from when it was within 4 ulp) with the JAX
    slope jitted, as the env builds it (``/ 1.414`` folded into a multiply)."""
    alt = np.asarray(jterrain.init_altitude(jax.random.key(7), 16, 24, 2))
    want = np.asarray(jax.jit(jterrain.get_slope)(jnp.asarray(alt)))
    got = tterrain.get_slope(torch.from_numpy(alt.copy())).numpy()
    assert got.shape == (2, 16, 24, 3, 3)
    np.testing.assert_array_equal(got, want)


def dense_float32(lo: float, hi: float, per_sign: int = 1 << 21) -> np.ndarray:
    """About ``per_sign`` float32 values of each sign in [lo, hi], evenly
    spaced in their bit patterns (so every binade is sampled alike), and the
    bounds themselves."""
    parts = [np.float32([lo, hi])]
    for sign, a, b in ((1.0, max(lo, 0.0), hi), (-1.0, max(-hi, 0.0), -lo)):
        if b > a:
            bits = np.float32([a, b]).view(np.int32).astype(np.int64)
            step = max((bits[1] - bits[0]) // per_sign, 1)
            mags = np.arange(bits[0], bits[1] + 1, step).astype(np.int32).view(np.float32)
            parts.append(sign * mags)
    return np.concatenate(parts).astype(np.float32)


@pytest.mark.parametrize("name,lo,hi", [
    ("cos", 0.0, float(np.float32(np.pi / 2))),  # the hills: dist / radius * pi / 2
    ("atan", -10.0, 10.0),  # the slopes: altitude differences (altitude < 9)
    ("exp", -7.1, 7.1),  # exp_slope: 0.078 * slope, slope in [-90, 90] degrees
])
def test_xla_transcendentals_equal_jax_on_the_terrain_range(name, lo, hi):
    """:func:`xla_cos`, :func:`xla_atan` and :func:`xla_exp` against
    ``jnp.cos``, ``jnp.arctan`` and ``jnp.exp`` on the CPU, bit for bit, on
    2 M float32 values of each sign spread evenly over the bit patterns of
    the range the terrain feeds each.  ``tests/xla_math_sweep.py`` checks
    every value of the three ranges."""
    x = dense_float32(lo, hi)
    want = np.asarray(jax.jit(getattr(jnp, "arctan" if name == "atan" else name))(x))
    got = getattr(tterrain, f"xla_{name}")(torch.from_numpy(x)).numpy()
    assert x.size > 2_000_000
    np.testing.assert_array_equal(got, want)


def test_winds_tables_and_mappings_equal_jax():
    np.testing.assert_array_equal(tterrain.WIND_THETAS, jterrain.WIND_THETAS)
    for use_hidden in (True, False):  # the dead branch: both give all 8
        for mine, theirs in zip(tterrain.get_winds(use_hidden, "cpu"),
                                jterrain.get_winds(use_hidden)):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    for theta in (0.0, 45.0, np.asarray([[90.0, 135.0]])):
        for mine, theirs in zip(tterrain.calc_pw(theta), jterrain.calc_pw(theta)):
            np.testing.assert_array_equal(mine, theirs)
    for n, k in ((2, 1), (3, 2), (4, 4)):
        mine, mine_ids = tterrain.create_up_to_k_mappings(n, k, "cpu")
        theirs, their_ids = jterrain.create_up_to_k_mappings(n, k)
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
        assert mine_ids == their_ids
    for name in ("init_density_same", "init_vegetation_same", "init_altitude_same"):
        np.testing.assert_array_equal(getattr(tterrain, name)(8, 8, 2, "cpu").numpy(),
                                      np.asarray(getattr(jterrain, name)(8, 8, 2)))


# --- extensions ---------------------------------------------------------------------------


def ext_inputs(seed, n=4, h=12, w=20):
    r = np.random.default_rng(seed)
    return r.integers(0, 4, (n, h, w)).astype(np.int32), r.integers(0, 2, n).astype(np.int32)


def test_blur_and_visibility_equal_jax():
    grid, night = ext_inputs(1)
    np.testing.assert_array_equal(text.apply_blur(torch.from_numpy(grid)).numpy(),
                                  np.asarray(jax.vmap(jext.apply_blur)(jnp.asarray(grid))))
    want = jax.vmap(jext.apply_visibility)(jnp.asarray(grid), jnp.asarray(night))
    got = text.apply_visibility(torch.from_numpy(grid), torch.from_numpy(night))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("skip_visibility,skip_blur", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_transform_grid_equals_jax(skip_visibility, skip_blur):
    grid, night = ext_inputs(2)
    want = jax.vmap(lambda g, n: jext.transform_grid(g, n, skip_visibility, skip_blur))(
        jnp.asarray(grid), jnp.asarray(night))
    got = text.transform_grid(torch.from_numpy(grid), torch.from_numpy(night),
                              skip_visibility, skip_blur)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("enabled", [True, False])
def test_apply_extensions_equals_jax(enabled):
    grid, night = ext_inputs(3)
    bits = np.random.default_rng(4).integers(0, 2, (4, text.total_extensions())).astype(np.int32)
    want = jax.vmap(lambda g, b, n: jnp.stack(jext.apply_extensions(g, b, n, enabled)))(
        jnp.asarray(grid), jnp.asarray(bits), jnp.asarray(night))
    got = text.apply_extensions(torch.from_numpy(grid), torch.from_numpy(bits),
                                torch.from_numpy(night), enabled)
    np.testing.assert_array_equal(torch.stack(got, dim=1).numpy(), np.asarray(want))
    assert text.extension_choices() == jext.extension_choices() == [(2, 1)]
    assert text.total_extensions() == jext.total_extensions()


# --- the env, XLA path --------------------------------------------------------------------


def port_env(jenv, **kw):
    """The port's env on the CPU with the JAX env's key and settings: it
    draws the same terrain from the key."""
    return TEnv(jenv.nrows, jenv.ncols, key=torch_key(jenv.starting_key),
                num_envs=jenv.num_envs, device="cpu", **kw)


def assert_same(tag, t_step, j_step):
    """Every leaf of a ``(obs, reward, terminated, truncated, info)`` tuple,
    or of an ``(obs, info)`` pair, bit for bit."""
    if len(t_step) == 2:
        (t_obs, t_info), (j_obs, j_info), extra = t_step, j_step, []
    else:
        t_obs, t_info, j_obs, j_info = t_step[0], t_step[4], j_step[0], j_step[4]
        extra = [("reward", t_step[1], j_step[1]), ("terminated", t_step[2], j_step[2]),
                 ("truncated", t_step[3], j_step[3])]
    rgb, ctx, info = interop.advanced_obs_to_numpy(t_obs, t_info)
    j_rgb, j_ctx = j_obs
    bad = [] if np.array_equal(rgb, np.asarray(j_rgb)) else ["rgb"]
    assert rgb.dtype == np.asarray(j_rgb).dtype
    for k, v in j_ctx["per_env_context"].items():
        v = np.asarray(jax.random.key_data(v)) if k == "key" else np.asarray(v)
        if k in BF16:
            v = v.view(np.uint16)
        if not np.array_equal(ctx["per_env_context"][k], v):
            bad.append(k)
    for k in ("position", "time"):
        if not np.array_equal(ctx[k], np.asarray(j_ctx[k])):
            bad.append(k)
    for k, v in j_info.items():
        if not np.array_equal(info[k], np.asarray(v)):
            bad.append("info." + k)
    for name, a, b in extra:
        if not np.array_equal(a.numpy(), np.asarray(b)):
            bad.append(name)
    assert not bad, f"{tag}: {bad}"


def clear_fire(obs, env_index, set_grid):
    """``obs`` with every fire of one env's true grid turned to tree."""
    rgb, ctx = obs
    ctx = dict(ctx)
    per_env = dict(ctx["per_env_context"])
    tg = per_env["true_grid"]
    per_env["true_grid"] = set_grid(tg, env_index)
    ctx["per_env_context"] = per_env
    return rgb, ctx


def jax_clear(tg, e):
    return tg.at[e].set(jnp.where(tg[e] == 2, 1, tg[e]))


def torch_clear(tg, e):
    tg = tg.clone()
    tg[e] = torch.where(tg[e] == 2, 1, tg[e])
    return tg


def run_both(jenv, tenv, steps, seed, clear_at=None):
    """reset, then ``steps`` x (stateless_step + conditional_reset) on both
    envs with the same random actions, every leaf compared after each call.
    At step ``clear_at`` env 0's fire is cleared first, so it terminates."""
    j_obs, j_info = jenv.reset()
    t_obs, t_info = tenv.reset()
    assert_same("reset", (t_obs, t_info), (j_obs, j_info))
    r = np.random.default_rng(seed)
    n = jenv.num_envs
    for i in range(steps):
        a = np.stack([r.integers(0, 9, n), r.integers(0, 2, n), np.zeros(n, int)], -1)
        ja, ta = jnp.asarray(a, jnp.int32), torch.tensor(a, dtype=torch.int32)
        if i == clear_at:
            j_obs, t_obs = clear_fire(j_obs, 0, jax_clear), clear_fire(t_obs, 0, torch_clear)
        js, ts = jenv.stateless_step(ja, j_obs, j_info), tenv.stateless_step(ta, t_obs, t_info)
        assert_same(f"step {i}", ts, js)
        if i == clear_at:
            assert bool(ts[2][0]) and not bool(ts[2][1:].any())
        jr, tr = jenv.conditional_reset(js, ja), tenv.conditional_reset(ts, ta)
        assert_same(f"reset {i}", tr, jr)
        j_obs, j_info, t_obs, t_info = jr[0], jr[4], tr[0], tr[4]
    return t_obs


@pytest.fixture(scope="module")
def jenv32():
    return JEnv(32, 32, key=jax.random.key(0), num_envs=4)


def test_xla_path_equals_jax_bit_for_bit(jenv32):
    """4 envs at 32x32, 10 steps; env 0 loses its fire before step 3 and
    is reset by ``conditional_reset``."""
    tenv = port_env(jenv32)
    assert not tenv.use_fused_ca  # the CPU default: the XLA-path counterpart
    obs = run_both(jenv32, tenv, 10, seed=0, clear_at=3)
    assert (obs[1]["per_env_context"]["true_grid"] == 2).sum() > 0


def test_state_carried_from_jax_steps_as_jax(jenv32):
    """``interop.advanced_obs_from_numpy`` takes a JAX mid-episode state as
    numpy leaves; the port steps on from it as the JAX env does."""
    j_obs, j_info = jenv32.reset()
    acts = jnp.asarray([[1, 1, 0], [5, 0, 0], [7, 1, 0], [4, 0, 0]], jnp.int32)
    for _ in range(2):
        js = jenv32.stateless_step(acts, j_obs, j_info)
        j_obs, j_info = js[0], js[4]
    rgb, ctx = j_obs
    leaves = {
        "per_env_context": {k: np.asarray(jax.random.key_data(v) if k == "key" else v)
                            for k, v in ctx["per_env_context"].items()},
        "shared_context": {k: np.asarray(v) for k, v in ctx["shared_context"].items()},
        "position": np.asarray(ctx["position"]),
        "time": np.asarray(ctx["time"]),
    }
    t_obs, t_info = interop.advanced_obs_from_numpy(
        np.asarray(rgb), leaves, {k: np.asarray(v) for k, v in j_info.items()}, device="cpu")
    assert t_obs[1]["per_env_context"]["exp_slope"].dtype == torch.bfloat16
    assert_same("carried", (t_obs, t_info), (j_obs, j_info))
    tenv = port_env(jenv32)
    ta = torch.tensor(np.asarray(acts))
    assert_same("step", tenv.stateless_step(ta, t_obs, t_info),
                jenv32.stateless_step(acts, j_obs, j_info))


def test_float32_observations_equal_jax():
    jenv = JEnv(32, 32, key=jax.random.key(2), num_envs=4, obs_dtype=jnp.float32)
    tenv = port_env(jenv, obs_dtype=torch.float32)
    run_both(jenv, tenv, 4, seed=1, clear_at=1)


def test_modf_mode_equals_jax():
    jenv = JEnv(16, 16, key=jax.random.key(3), num_envs=2, ca_repeat_mode="modf")
    tenv = port_env(jenv, ca_repeat_mode="modf")
    assert tenv._max_repeats == jenv._max_repeats
    run_both(jenv, tenv, 4, seed=2)


# (H, W, envs, use_hidden): each case of terrain.bundle_slope's rule.  W % 8 == 0
# (32, 128, 256: the 8-lane body only), W < 16 (13: the scalar loop only), a
# remainder after 16 (23) and after 40 (42), and the uniform terrain.
TERRAIN_CASES = [(32, 32, 4, True), (16, 128, 2, True), (12, 13, 2, True),
                 (17, 23, 3, True), (12, 42, 2, True), (256, 256, 2, True),
                 (16, 16, 2, False)]


@pytest.mark.parametrize("case", TERRAIN_CASES, ids=lambda c: "x".join(map(str, c[:3]))
                         + ("" if c[3] else "-uniform"))
def test_terrain_drawn_from_the_key_matches_jax(case, request, record_property):
    """The port's own terrain bundle from the same key, every field bit for
    bit, ``slope`` included (the counts of elements that differ are
    recorded: 0).  The slope follows ``bundle_slope``'s rule, read from
    jax 0.9.0's x86 CPU code; a gap in it alone points there first."""
    h, w, n, use_hidden = case
    jenv = (request.getfixturevalue("jenv32") if case == TERRAIN_CASES[0]
            else JEnv(h, w, key=jax.random.key(h + w), num_envs=n, use_hidden=use_hidden))
    tenv = TEnv(h, w, key=torch_key(jenv.starting_key), num_envs=n, device="cpu",
                use_hidden=use_hidden)
    mine, theirs = tenv._terrain_ctx, jenv._terrain_ctx
    assert set(mine) == set(TERRAIN_KEYS)
    differing = {k: int((bf16_ulps(mine[k], theirs[k]) if k in BF16
                         else mine[k].numpy() != np.asarray(theirs[k])).astype(bool).sum())
                 for k in TERRAIN_KEYS}
    for k, count in differing.items():
        record_property(f"{k}_elements_differing", count)
    if use_hidden:
        # the slope of the altitude alone, as jax.jit(get_slope) rounds it,
        # is not the bundle's
        plain = tterrain.get_slope(mine["altitude"]).numpy() != np.asarray(theirs["slope"])
        record_property("get_slope_elements_differing", int(plain.sum()))
    assert differing == dict.fromkeys(TERRAIN_KEYS, 0), (
        f"{differing}: bundle_slope's rule is read from jax 0.9.0's x86 CPU code "
        f"(jax {jax.__version__} here)")
    assert mine["exp_slope"].is_contiguous()
    assert (mine["slope"].abs().sum() > 0) == use_hidden


def test_explicit_terrain_is_the_envs():
    """``terrain=`` replaces the draw: the env keeps the dict it is given and
    its reset carries those fields."""
    key = rng.key(0, device="cpu")
    given = TEnv(16, 16, key=rng.key(1, device="cpu"), num_envs=2, device="cpu")._terrain_ctx
    env = TEnv(16, 16, key=key, num_envs=2, device="cpu", terrain=given)
    drawn = TEnv(16, 16, key=key, num_envs=2, device="cpu")._terrain_ctx
    assert not torch.equal(drawn["altitude"], given["altitude"])
    per_env = env.reset()[0][1]["per_env_context"]
    for k in TERRAIN_KEYS:
        assert torch.equal(env._terrain_ctx[k], given[k]), k
        if k in per_env:
            assert torch.equal(per_env[k], given[k]), k


# --- the env, fused path --------------------------------------------------------------------


def test_fused_path_equals_the_interpreted_jax_kernel(monkeypatch):
    """2 envs at 16x128, 5 steps: the JAX env with ``use_pallas_ca=True``
    and its kernel interpreted, the port with ``use_fused_ca=True`` on the
    CPU, both with zero draws, bit for bit."""
    monkeypatch.setattr(pa, "alexandridis_fused_step",
                        functools.partial(pa.alexandridis_fused_step, interpret=True))
    monkeypatch.setattr(ak, "alexandridis_draws", lambda seeds, h, w: (
        torch.zeros((seeds.shape[0], h, w)),
        torch.zeros((seeds.shape[0], h, w), dtype=torch.int64)))
    jenv = JEnv(16, 128, key=jax.random.key(1), num_envs=2, use_pallas_ca=True)
    assert jenv.use_pallas_ca
    tenv = port_env(jenv, use_fused_ca=True)
    obs = run_both(jenv, tenv, 5, seed=3)
    assert (obs[1]["per_env_context"]["true_grid"] == 2).sum() > 20  # the fire spread


def test_fused_flag():
    key = rng.key(0, device="cpu")
    assert TEnv(16, 16, key=key, num_envs=1, device="cpu").use_fused_ca is False
    assert TEnv(64, 64, key=key, num_envs=1, device="cpu", use_fused_ca=True).use_fused_ca
    # the kernel covers one CA application a step and no pinecones: warn and
    # run the XLA-path counterpart, as gymca_tpu/envs/advanced.py:170-181 does
    with pytest.warns(UserWarning, match="ca_repeat_mode='modf'.*falling back to the XLA"):
        env = TEnv(16, 128, key=key, num_envs=1, device="cpu", use_fused_ca=True,
                   ca_repeat_mode="modf")
    assert env.use_fused_ca is False
    with pytest.warns(UserWarning, match="enable_pinecones=True.*falling back to the XLA"):
        env = TEnv(16, 128, key=key, num_envs=1, device="cpu", use_fused_ca=True,
                   enable_pinecones=True)
    assert env.use_fused_ca is False


# --- contract tests (tests/test_advanced.py) on the port ----------------------------------


@pytest.fixture(scope="module")
def env16():
    return TEnv(16, 16, key=rng.key(0, device="cpu"), num_envs=4, enable_extensions=True,
                device="cpu")


@pytest.fixture(scope="module")
def reset16(env16):
    return env16.reset()


def idle(n, ext=0):
    return torch.tensor([[4, 0, ext]] * n, dtype=torch.int32)


class TestContract:
    def test_spaces(self, env16):
        assert env16.action_space.nvec == (9, 2)
        assert env16.total_action_space.nvec == (9, 2, 3)
        assert env16._extension_lookups[0].shape == (3, 2)

    def test_reset_obs(self, env16, reset16):
        (rgb, ctx), info = reset16
        assert rgb.shape == (4, 16, 16, 3) and rgb.dtype == torch.uint8
        assert set(ctx) == {"per_env_context", "shared_context", "position", "time"}
        assert set(ctx["per_env_context"]) == env16.PER_ENV_CONTEXT_KEYS
        tg = ctx["per_env_context"]["true_grid"]
        assert ((tg == 2).sum(dim=(1, 2)) == 2).all()
        assert ctx["position"].tolist() == [[2, 13]] * 4
        counts = env16.count_cells(tg)
        assert (counts[0] + counts[1] + counts[2] == 16 * 16).all()
        assert (counts[2] == 2).all()

    def test_step_contract(self, env16, reset16):
        obs, info = reset16
        obs2, reward, term, trunc, info2 = env16.stateless_step(idle(4), obs, info)
        assert obs2[0].shape == (4, 16, 16, 3) and reward.shape == (4,)
        assert bool((reward <= 0).all()) and not bool(term.any())
        assert float(info2["steps_elapsed"][0]) == 1.0

    def test_shoot_writes_dousing(self, env16, reset16):
        obs, info = reset16
        a = torch.tensor([[4, 1, 0]] * 4, dtype=torch.int32)
        step = env16.stateless_step(a, obs, info)
        dc = step[0][1]["per_env_context"]["dousing_count"]
        pos = step[0][1]["position"]
        assert int(dc.sum()) == 4
        assert all(int(dc[i, pos[i, 0], pos[i, 1]]) == 1 for i in range(4))

    def test_extension_channels_equal_jax(self, env16, reset16):
        """``build_observation_on_extensions`` on the batch against the JAX
        env's, env by env, on the same grid; and its gating."""
        jenv = JEnv(16, 16, key=jax.random.key(0), num_envs=4, enable_extensions=True)
        (_, ctx), _ = reset16
        pe = ctx["per_env_context"]
        grid, pos = pe["true_grid"], ctx["position"]
        for ext_id, bits in ((0, (0, 0)), (1, (1, 0)), (2, (0, 1))):
            full = torch.tensor([[4, 0, *bits]] * 4, dtype=torch.int32)
            rgb, ext = env16.build_observation_on_extensions(grid, pos, full, pe)
            assert ext.shape == (4, 16, 16, 5)
            for e in range(4):
                jpe = {"is_night": jnp.asarray(int(pe["is_night"][e])),
                       "dousing_count": jnp.asarray(pe["dousing_count"][e].numpy())}
                j_rgb, j_ext = jenv.build_observation_on_extensions(
                    jnp.asarray(grid[e].numpy()), jnp.asarray(pos[e].numpy()),
                    jnp.asarray(full[e].numpy()), jpe, None)
                np.testing.assert_array_equal(rgb[e].numpy(), np.asarray(j_rgb))
                np.testing.assert_array_equal(ext[e].numpy(), np.asarray(j_ext))
            if ext_id == 0:
                assert float(ext[..., 3:].abs().sum()) == 0.0
            if ext_id == 1:
                assert float(ext[..., 3].abs().sum()) > 0 and float(ext[..., 4].abs().sum()) == 0
                assert not torch.equal(ext[..., 3], ext[..., 0])  # blurred by day

    def test_full_actions_mapping(self, env16):
        action = torch.tensor([[4, 0, 0], [4, 0, 1], [4, 0, 2], [4, 1, 2]], dtype=torch.int32)
        full = env16._create_full_actions(action)
        assert full.shape == (4, 4)
        assert full[:, 2:].tolist() == [[0, 0], [1, 0], [0, 1], [0, 1]]
        with pytest.raises(ValueError, match="columns"):
            env16._create_full_actions(action[:, :2])

    def test_conditional_reset_restores_fire(self, env16, reset16):
        obs, info = reset16
        obs = clear_fire(obs, 0, torch_clear)
        step = env16.stateless_step(idle(4), obs, info)
        assert bool(step[2][0])
        obs2, reward, term, trunc, info2 = env16.conditional_reset(step, idle(4))
        assert not bool(term.any())
        tg2 = obs2[1]["per_env_context"]["true_grid"]
        assert int((tg2[0] == 2).sum()) == 2 and float(info2["steps_elapsed"][0]) == 0.0
        assert int((tg2[1] == 2).sum()) >= 1

    def test_fresh_initial_states_differ(self, env16, reset16):
        obs, info = reset16
        grids = []
        for trial in range(2):
            rgb, ctx = clear_fire(obs, 0, torch_clear)
            ctx["per_env_context"]["key"] = rng.fold_in(ctx["per_env_context"]["key"],
                                                        trial + 100)
            step = env16.stateless_step(idle(4), (rgb, ctx), info)
            grids.append(env16.conditional_reset(step, idle(4))[0][1]["per_env_context"]
                         ["true_grid"][0])
        assert not torch.equal(grids[0], grids[1])

    def test_palettes_and_dousing_tint(self, env16, reset16):
        (_, ctx), _ = reset16
        pe, pos = ctx["per_env_context"], ctx["position"]
        grid, dousing = pe["true_grid"], pe["dousing_count"]
        day = env16._grid_to_rgb(grid, torch.zeros(4, dtype=torch.int32), dousing, pos)
        night = env16._grid_to_rgb(grid, torch.ones(4, dtype=torch.int32), dousing, pos)
        assert not torch.equal(day, night)
        assert int(day[0, pos[0, 0], pos[0, 1]].sum()) == 0  # the agent is black
        doused = dousing.clone()
        doused[:, 5, 5] = 1
        tinted = env16._grid_to_rgb(grid, torch.zeros(4, dtype=torch.int32), doused, pos)
        assert not torch.equal(tinted[:, 5, 5], day[:, 5, 5])
        assert bool((tinted[:, 5, 5, 2] > tinted[:, 5, 5, 0]).all())  # blue by day


def test_speed_multiplier_scales_agent_speed():
    for m in (1.0, 4.0):
        mine = TEnv(16, 16, key=rng.key(0, device="cpu"), num_envs=1, speed_multiplier=m,
                    device="cpu")
        theirs = JEnv(16, 16, key=jax.random.key(0), num_envs=1, speed_multiplier=m)
        for attr in ("_t_act_move", "_t_act_shoot", "_t_env_any", "_max_repeats"):
            assert getattr(mine, attr) == getattr(theirs, attr)


def test_uint8_rgb_integer_path_bit_identical():
    """The integer uint8 render equals round() of the float32 one, ties
    included, and both equal the JAX env's renders."""
    key = rng.key(0, device="cpu")
    u8 = TEnv(8, 8, key=key, num_envs=2, device="cpu")
    f32 = TEnv(8, 8, key=key, num_envs=2, device="cpu", obs_dtype=torch.float32)
    j_u8 = JEnv(8, 8, key=jax.random.key(0), num_envs=1)
    j_f32 = JEnv(8, 8, key=jax.random.key(0), num_envs=1, obs_dtype=jnp.float32)
    vals = (torch.arange(64, dtype=torch.float32).reshape(8, 8) % 3).expand(2, 8, 8)
    dousing = ((torch.arange(64, dtype=torch.int32).reshape(8, 8) // 2) % 3).expand(2, 8, 8)
    pos = torch.tensor([[3, 5], [0, 0]], dtype=torch.int32)
    night = torch.tensor([0, 1], dtype=torch.int32)
    got_u8 = u8._grid_to_rgb(vals, night, dousing, pos)
    got_f32 = f32._grid_to_rgb(vals, night, dousing, pos)
    assert got_u8.dtype == torch.uint8 and got_f32.dtype == torch.float32
    np.testing.assert_array_equal(got_u8.numpy(), torch.round(got_f32).to(torch.uint8).numpy())
    doused_empty = (vals[1] == 0) & (dousing[1] == 1)
    assert int(got_u8[1][doused_empty][:, 0].min()) == 218  # (105 + 3*255)/4 = 217.5
    for e in range(2):
        args = (jnp.asarray(vals[e].numpy()), jnp.asarray(int(night[e])),
                jnp.asarray(dousing[e].numpy()), jnp.asarray(pos[e].numpy()))
        np.testing.assert_array_equal(got_u8[e].numpy(), np.asarray(j_u8._grid_to_rgb(*args)))
        np.testing.assert_array_equal(got_f32[e].numpy(), np.asarray(j_f32._grid_to_rgb(*args)))
