"""The port's operators against the JAX package's, bit for bit (tolerance 0).

Inputs are made with numpy from a seed; the JAX side runs one env at a time
under ``jax.vmap``, the port takes the batch as is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymca_torch.core.operator import Identity as TIdentity
from gymca_torch.core.operator import Sequence as TSequence
from gymca_torch.ops import move_modify as tmm
from gymca_torch.ops import repeat_ca as trc
from gymca_torch.ops import stencil as tst
from gymca_torch.ops import windy as twi
from gymca_torch.ops.windy_kernel import windy_weights_from_roll as t_weights
from gymca_tpu.core.operator import Identity as JIdentity
from gymca_tpu.core.operator import Sequence as JSequence
from gymca_tpu.ops import move_modify as jmm
from gymca_tpu.ops import repeat_ca as jrc
from gymca_tpu.ops import stencil as jst
from gymca_tpu.ops import windy as jwi
from gymca_tpu.ops.pallas_kernels import windy_weights_from_roll as j_weights

EMPTY, TREE, FIRE = 0, 3, 25


def grids(seed, n, h, w, dtype=np.int32, p=(0.2, 0.65, 0.15)):
    return np.random.default_rng(seed).choice(
        np.asarray([EMPTY, TREE, FIRE], dtype), size=(n, h, w), p=p)


def key_data(seed, n):
    kd = np.random.default_rng(seed).integers(0, 2**32, (n, 2), dtype=np.uint64)
    return kd.astype(np.uint32)


def T(x):
    return torch.as_tensor(np.asarray(x))


def test_neighbor_offsets_match():
    assert tst.NEIGHBOR_OFFSETS == jst.NEIGHBOR_OFFSETS


@pytest.mark.parametrize("fill", [0, -1])
def test_shift_and_moore_shifts_match(fill):
    g = grids(0, 2, 5, 7)
    for dr, dc in jst.NEIGHBOR_OFFSETS:
        np.testing.assert_array_equal(
            tst.shift(T(g), dr, dc, fill).numpy(),
            np.asarray(jst.shift(jnp.asarray(g), dr, dc, fill)))
    got = list(tst.moore_shifts(T(g), fill))
    want = list(jst.moore_shifts(jnp.asarray(g), fill))
    assert [o for o, _ in got] == [o for o, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", [np.int32, np.int8])
def test_windy_step_from_success_matches(dtype):
    g = grids(1, 6, 24, 20, dtype)
    success = np.random.default_rng(2).random((6, 3, 3)) < 0.6
    want = np.asarray(jax.vmap(lambda gg, s: jwi.windy_step_from_success(
        gg, s, empty=EMPTY, tree=TREE, fire=FIRE))(jnp.asarray(g), jnp.asarray(success)))
    got = twi.windy_step_from_success(T(g), T(success), empty=EMPTY, tree=TREE, fire=FIRE)
    assert got.dtype == T(g).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    # one mask shared by every grid, as spatially sharded callers pass it
    want1 = np.asarray(jwi.windy_step_from_success(
        jnp.asarray(g), jnp.asarray(success[0]), empty=EMPTY, tree=TREE, fire=FIRE))
    got1 = twi.windy_step_from_success(T(g), T(success[0]), empty=EMPTY, tree=TREE, fire=FIRE)
    np.testing.assert_array_equal(got1.numpy(), want1)


def test_windy_step_and_operator_match():
    g = grids(3, 5, 16, 16)
    kd = key_data(4, 5)
    wind = np.random.default_rng(5).random((3, 3)).astype(np.float32)
    keys_j = jax.random.wrap_key_data(jnp.asarray(kd))
    want = np.asarray(jax.vmap(lambda gg, k: jwi.windy_step(
        gg, jnp.asarray(wind), k, empty=EMPTY, tree=TREE, fire=FIRE))(jnp.asarray(g), keys_j))
    keys_t = T(kd.astype(np.int64))
    got = twi.windy_step(T(g), T(wind), keys_t, empty=EMPTY, tree=TREE, fire=FIRE)
    np.testing.assert_array_equal(got.numpy(), want)
    op_grid, op_wind = twi.WindyForestFire(EMPTY, TREE, FIRE)(T(g), None, T(wind), keys_t)
    np.testing.assert_array_equal(op_grid.numpy(), want)
    assert op_wind is not None


def test_windy_breaks_and_encoding():
    assert tuple(twi.windy_breaks(EMPTY, TREE, FIRE)) == tuple(jwi.windy_breaks(EMPTY, TREE, FIRE))
    assert (twi.IDENTITY, twi.PROPAGATION) == (jwi.IDENTITY, jwi.PROPAGATION)
    twi.assert_windy_encoding(EMPTY, TREE, FIRE)
    for bad in [(3, 0, 25), (0, 3, 4), (0, 24, 25)]:
        with pytest.raises(ValueError):
            twi.assert_windy_encoding(*bad)


def test_weights_from_roll_match():
    r = np.random.default_rng(6)
    wind = r.random((3, 3)).astype(np.float32)
    roll = r.random((7, 3, 3)).astype(np.float32)
    want = np.asarray(j_weights(jnp.asarray(wind), jnp.asarray(roll)))
    got = t_weights(T(wind), T(roll))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_move_position_matches_every_action_at_every_border():
    nrows, ncols = 6, 9
    pos = np.asarray([[r, c] for r in (0, 3, nrows - 1) for c in (0, 4, ncols - 1)], np.int32)
    pos = np.repeat(pos, 9, axis=0)
    act = np.tile(np.arange(9, dtype=np.int32), len(pos) // 9)
    jm = jmm.Move(jmm.DEFAULT_DIRECTIONS)
    tm = tmm.Move(tmm.DEFAULT_DIRECTIONS, device="cpu")
    want = np.asarray(jmm.move_position(jnp.asarray(pos), jnp.asarray(act), nrows, ncols,
                                        jm.drow, jm.dcol))
    got = tmm.move_position(T(pos), T(act), nrows, ncols, tm.drow, tm.dcol)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_modify_and_move_modify_match():
    n, h, w = 12, 6, 7
    g = grids(7, n, h, w)
    r = np.random.default_rng(8)
    pos = np.stack([r.integers(0, h, n), r.integers(0, w, n)], -1).astype(np.int32)
    acts = np.stack([r.integers(0, 9, n), r.integers(0, 2, n)], -1).astype(np.int32)
    effects = {TREE: EMPTY}

    jmod, tmod = jmm.Modify(effects), tmm.Modify(effects, device="cpu")
    jg, (jp, jh) = jax.vmap(jmod.update, in_axes=(0, 0, 0))(
        jnp.asarray(g), jnp.asarray(acts[:, 1]), jnp.asarray(pos))
    tg, (tp, th) = tmod(T(g), T(acts[:, 1]), T(pos))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(g, grids(7, n, h, w))  # input left unchanged

    jmv = jmm.MoveModify(jmm.Move(jmm.DEFAULT_DIRECTIONS), jmod)
    tmv = tmm.MoveModify(tmm.Move(tmm.DEFAULT_DIRECTIONS, device="cpu"), tmod)
    jg, (jp, jh) = jax.vmap(jmv.update)(jnp.asarray(g), jnp.asarray(acts), jnp.asarray(pos))
    tg, (tp, th) = tmv(T(g), T(acts), T(pos))
    for a, b in [(tg, jg), (tp, jp), (th, jh)]:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_modify_without_effects_never_hits():
    g = grids(9, 3, 4, 4)
    _, (_, hit) = tmm.Modify({}, device="cpu")(T(g), T(np.ones(3, np.int32)), T(np.zeros((3, 2), np.int32)))
    assert not hit.any()


@pytest.mark.parametrize("mode", ["modf", "single"])
def test_repeat_ca_matches(mode):
    n, h, w = 6, 12, 12
    g = grids(10, n, h, w)
    r = np.random.default_rng(11)
    wind = np.broadcast_to(r.random((3, 3)).astype(np.float32), (n, 3, 3)).copy()
    accu = (r.random(n) * 1.2).astype(np.float32)
    acts = np.stack([r.integers(0, 9, n), r.integers(0, 2, n)], -1).astype(np.int32)
    kd = key_data(12, n)
    move_t = np.asarray([0.7] * 4 + [0.0] + [0.7] * 4, np.float32)
    shoot_t = np.asarray([0.0, 1.3], np.float32)

    def rep(repeat_mod, windy_mod, tensor):
        ca = windy_mod.WindyForestFire(EMPTY, TREE, FIRE)
        mt, st, t_any = tensor(move_t), tensor(shoot_t), tensor(np.float32(0.001))

        def t_acting(a):
            return mt[a[..., 0]] + st[a[..., 1]]

        return repeat_mod.RepeatCA(ca, t_acting, lambda s: t_any, max_repeats=3, mode=mode)

    jrep = rep(jrc, jwi, jnp.asarray)
    trep = rep(trc, twi, lambda x: torch.as_tensor(np.asarray(x)))
    jg, (jw, jf) = jax.vmap(lambda gg, a, wd, t, k: jrep(gg, a, (wd, t), k))(
        jnp.asarray(g), jnp.asarray(acts), jnp.asarray(wind), jnp.asarray(accu),
        jax.random.wrap_key_data(jnp.asarray(kd)))
    tg, (tw, tf) = trep(T(g), T(acts), (T(wind), T(accu)), T(kd.astype(np.int64)))
    for a, b in [(tg, jg), (tw, jw), (tf, jf)]:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_repeat_ca_rejects_unknown_mode():
    with pytest.raises(ValueError):
        trc.RepeatCA(TIdentity(), lambda a: 0, lambda s: 0, mode="bogus")


def test_modf_matches_jnp_modf():
    x = np.asarray([0.0, 0.25, 0.999, 1.0, 1.4375, 2.75, -0.5, -1.25], np.float32)
    got_f, got_w = trc.modf(T(x))
    want_f, want_w = jnp.modf(jnp.asarray(x))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))


def test_identity_and_sequence_match():
    g = grids(13, 4, 8, 8)
    kd = key_data(14, 4)
    wind = np.full((4, 3, 3), 0.8, np.float32)
    jseq = JSequence((JIdentity(), jwi.WindyForestFire(), jwi.WindyForestFire()))
    tseq = TSequence((TIdentity(), twi.WindyForestFire(), twi.WindyForestFire()))
    jg, _ = jax.vmap(jseq.update)(jnp.asarray(g), jnp.zeros(4), jnp.asarray(wind),
                                  jax.random.wrap_key_data(jnp.asarray(kd)))
    tg, _ = tseq(T(g), None, T(wind), T(kd.astype(np.int64)))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert tseq.deterministic is False
    assert [type(op).__name__ for op in tseq.tree_flatten_ops()] == [
        "Sequence", "Identity", "WindyForestFire", "WindyForestFire"]
