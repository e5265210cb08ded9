"""``gymca_torch.rng`` and the spec samplers against ``jax.random``.

Key data is made with numpy from a seed and handed to both packages; every
draw must be equal bit for bit (tolerance 0), ``exponential`` included: the
port reproduces the float32 ``log1p`` of XLA's CPU backend.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymca_torch import rng
from gymca_torch.core import spaces as tspaces
from gymca_tpu.core import spaces as jspaces


def key_data(seed, n):
    kd = np.random.default_rng(seed).integers(0, 2**32, (n, 2), dtype=np.uint64)
    return kd.astype(np.uint32)


def jax_keys(kd):
    return jax.random.wrap_key_data(jnp.asarray(kd))


def torch_keys(kd):
    return torch.as_tensor(kd.astype(np.int64))


def jdata(keys):
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 42, 2**31 + 7, 2**32 - 1])
def test_key_matches_jax_key(seed):
    np.testing.assert_array_equal(rng.key(seed, device="cpu").numpy(),
                                  jdata(jax.random.key(seed)))


def test_key_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        rng.key(-1, device="cpu")
    with pytest.raises(ValueError):
        rng.key(2**32, device="cpu")


@pytest.mark.parametrize("num", [1, 2, 6])
def test_split_matches_jax(num):
    kd = key_data(1, 5)
    want = jdata(jax.vmap(lambda k: jax.random.split(k, num))(jax_keys(kd)))
    np.testing.assert_array_equal(rng.split(torch_keys(kd), num).numpy(), want)


def test_split_of_one_key_and_of_nested_batches():
    kd = key_data(2, 6)
    want = jdata(jax.random.split(jax_keys(kd[:1])[0], 3))
    np.testing.assert_array_equal(rng.split(torch_keys(kd[0]), 3).numpy(), want)
    nested = torch_keys(kd).reshape(2, 3, 2)
    np.testing.assert_array_equal(rng.split(nested, 2).reshape(6, 2, 2).numpy(),
                                  rng.split(torch_keys(kd), 2).numpy())


@pytest.mark.parametrize("data", [0, 7, 2**31 + 5])
def test_fold_in_matches_jax(data):
    kd = key_data(3, 4)
    want = jdata(jax.vmap(lambda k: jax.random.fold_in(k, data))(jax_keys(kd)))
    np.testing.assert_array_equal(rng.fold_in(torch_keys(kd), data).numpy(), want)


@pytest.mark.parametrize("shape", [(), (3, 3), (4, 5, 6)])
def test_random_bits_match_jax(shape):
    kd = key_data(4, 3)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, shape, dtype=jnp.uint32))(jax_keys(kd)))
    np.testing.assert_array_equal(rng.random_bits(torch_keys(kd), shape).numpy(),
                                  want.astype(np.int64))


@pytest.mark.parametrize("shape,lo,hi", [
    ((3, 3), 0.0, 1.0), ((), 0.0, 1.0), ((64, 32), 0.0, 1.0),
    ((500,), -2.5, 3.7), ((500,), 5.0, 1e6),
])
def test_uniform_matches_jax(shape, lo, hi):
    kd = key_data(5, 8)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, shape, dtype=jnp.float32, minval=lo, maxval=hi))(jax_keys(kd)))
    got = rng.uniform(torch_keys(kd), shape, lo, hi).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lo,hi", [(1e-20, 3.0), (-1e-20, 3.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_uniform_matches_jax_with_minval_far_below_the_last_bit(seed, lo, hi):
    """2**20 draws, bit for bit.  XLA fuses the multiply-add and rounds once;
    a float64 add then a cast to float32 rounded twice and differed in
    87,338 of these draws at (1e-20, 3.0), key 0."""
    k = jax.random.key(seed)
    want = np.asarray(jax.jit(lambda k: jax.random.uniform(
        k, (2**20,), dtype=jnp.float32, minval=lo, maxval=hi))(k))
    got = rng.uniform(torch_keys(jdata(k)), (2**20,), lo, hi).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_box_spec_sample_with_low_far_below_the_last_bit():
    """``BoxSpec(1e-20, 3.0)`` over 4 keys x 256 x 256 draws, bit for bit
    (21,806 differed before the fused multiply-add was reproduced)."""
    kd = key_data(12, 4)
    make = lambda m: m.BoxSpec(1e-20, 3.0, shape=(256, 256))  # noqa: E731
    want = np.asarray(jax.jit(jax.vmap(make(jspaces).sample))(jax_keys(kd)))
    got = make(tspaces).sample(torch_keys(kd)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n", [7, 64, 1024, 65536])
@pytest.mark.parametrize("seed", [0, 3])
def test_permutation_matches_jax(seed, n):
    """``rng.permutation`` equals ``jax.random.permutation`` of ``n`` (one
    round of sort below 1626 elements, two from there), and indexing with it
    permutes a 1-D and a 4-D leaf as JAX permutes them with the same key."""
    k = jax.random.key(seed)
    perm = rng.permutation(torch_keys(jdata(k)), n).numpy()
    np.testing.assert_array_equal(perm, np.asarray(jax.random.permutation(k, n)))
    r = np.random.default_rng(n)
    flat = r.normal(size=n).astype(np.float32)
    grid = r.integers(0, 256, (n, 2, 3, 3), dtype=np.uint8)
    np.testing.assert_array_equal(flat[perm], np.asarray(jax.random.permutation(k, flat)))
    np.testing.assert_array_equal(grid[perm], np.asarray(jax.random.permutation(k, grid)))


def test_xla_log_matches_jax_on_gumbel_draws():
    """``rng.xla_log`` against jitted ``jnp.log`` on all 2**23 values a
    uniform draw takes and on their negated logs, and the Gumbel noise
    ``-log(-log(u))`` the trainer samples with, bit for bit."""
    k = np.arange(2**23, dtype=np.uint32)
    u = (k | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    log = jax.jit(jnp.log)
    for x in (u, -np.asarray(log(u))):
        want = np.asarray(log(x))
        got = rng.xla_log(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    want = np.asarray(jax.jit(lambda x: -jnp.log(-jnp.log(x)))(u))
    got = (-rng.xla_log(-rng.xla_log(torch.from_numpy(u)))).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("lo,hi", [(0, 21), (0, 9), (0, 2), (-5, 70000), (0, 2**31 - 1)])
def test_randint_matches_jax(lo, hi):
    kd = key_data(6, 6)
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(
        k, (7, 3), lo, hi, dtype=jnp.int32))(jax_keys(kd)))
    got = rng.randint(torch_keys(kd), (7, 3), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_randint_rejects_empty_range():
    with pytest.raises(ValueError):
        rng.randint(torch_keys(key_data(0, 1)), (), 3, 3)


@pytest.mark.parametrize("p", [(0.1, 0.9, 0.0), (0.2, 0.3, 0.15, 0.35), (0.0, 1.0)])
def test_choice_matches_jax(p):
    kd = key_data(7, 4)
    n = len(p)
    want = np.asarray(jax.vmap(lambda k: jax.random.choice(
        k, n, shape=(16, 16), p=jnp.asarray(p, jnp.float32)))(jax_keys(kd)))
    np.testing.assert_array_equal(rng.choice(torch_keys(kd), n, (16, 16), p).numpy(), want)


def test_exponential_within_one_ulp_of_jax():
    """Exact: within zero units in the last place."""
    kd = key_data(8, 4)
    want = np.asarray(jax.vmap(lambda k: jax.random.exponential(
        k, (1000,), dtype=jnp.float32))(jax_keys(kd)))
    np.testing.assert_array_equal(rng.exponential(torch_keys(kd), (1000,)).numpy(), want)


def test_log1p_matches_xla_on_every_uniform_value():
    """``-log1p(-u)`` on all 2**23 float32 values ``jax.random.uniform`` can
    take (``k * 2**-23``), against ``jnp.log1p`` on the CPU, bit for bit."""
    k = np.arange(2**23, dtype=np.uint32)
    u = (k | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    want = np.asarray(jax.jit(lambda x: -jnp.log1p(-x))(jnp.asarray(u)))
    got = (-rng._log1p_neg(torch.from_numpy(u))).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


SPEC_PAIRS = [
    ("grid", lambda m: m.GridSpec(values=(0, 3, 25), probs=(0.1, 0.9, 0.0), shape=(8, 8))),
    ("grid_n", lambda m: m.GridSpec(n=4, shape=(5, 6))),
    ("box", lambda m: m.BoxSpec(0.0, 1.0, shape=(3, 3))),
    ("discrete", lambda m: m.DiscreteSpec(9)),
    ("multidiscrete", lambda m: m.MultiDiscreteSpec((9, 2))),
    ("tuple", lambda m: m.TupleSpec((m.BoxSpec(-1.0, 2.0, shape=(2,)),
                                     m.MultiDiscreteSpec((16, 16))))),
    ("dict", lambda m: m.DictSpec.of(a=m.DiscreteSpec(5), b=m.BoxSpec(0.0, 1.0, shape=(4,)))),
]


@pytest.mark.parametrize("name,make", SPEC_PAIRS, ids=[n for n, _ in SPEC_PAIRS])
def test_spec_samples_match_jax(name, make):
    kd = key_data(9, 3)
    want = jax.tree.map(np.asarray, jax.vmap(make(jspaces).sample)(jax_keys(kd)))
    got = make(tspaces).sample(torch_keys(kd))
    flat_w = jax.tree.leaves(want)
    flat_g = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got,
                                          is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert len(flat_w) == len(flat_g)
    for w, g in zip(flat_w, flat_g):
        np.testing.assert_array_equal(g, w)


def test_grid_spec_contains_and_validates():
    spec = tspaces.GridSpec(values=(0, 3, 25), shape=(4, 4))
    sample = spec.sample(torch_keys(key_data(10, 1)))[0]
    assert spec.contains(sample)
    assert not spec.contains(np.full((4, 4), 7))
    assert not spec.contains(np.zeros((3, 4)))
    with pytest.raises(ValueError):
        tspaces.GridSpec(shape=(2, 2))
    with pytest.raises(ValueError):
        tspaces.GridSpec(values=(0, 1), probs=(1.0,), shape=(2, 2))


# --- the hash pass's wrapper (``rng.threefry_launch``) on the CPU ------------------


def test_cpu_keys_take_the_eager_path_and_launch_nothing():
    """Every draw on CPU keys runs ``threefry_plain`` and leaves the launch
    counter where it was; the wrapper equals its plain version there."""
    keys = torch_keys(key_data(13, 4))
    before = rng.threefry_launch.launches
    rng.split(keys, 3), rng.fold_in(keys, 2**32 - 1), rng.random_bits(keys, (2, 3))
    rng.uniform(keys, (5,), 0.0, 5.0), rng.randint(keys, (5,), -3, 80)
    rng.choice(keys, 3, (4, 4), (0.2, 0.5, 0.3)), rng.permutation(keys[0], 50)
    rng.poisson(keys, 1.0, (3,), max_count=4), rng.normal(keys, (3,))
    rng.exponential(keys, (3,))
    assert rng.threefry_launch.launches == before
    for form, kw in [("keys", {"base": 9}), ("bits", {}), ("uniform", {"minval": -2.0}),
                     ("randint", {"minval": 4, "maxval": 11})]:
        assert torch.equal(rng.threefry_launch(keys, 6, form, **kw),
                           rng.threefry_plain(keys, 6, form, **kw))


@pytest.mark.parametrize("case", ["dtype", "last_dim", "scalar", "device", "form", "count",
                                  "base", "randint_bounds"])
def test_threefry_launch_rejects_bad_operands(case):
    keys = torch_keys(key_data(14, 3))
    args, kw = (keys, 4, "bits"), {}
    if case == "dtype":
        args = (keys.to(torch.int32), 4, "bits")
    elif case == "last_dim":
        args = (torch.zeros((3, 3), dtype=torch.int64), 4, "bits")
    elif case == "scalar":
        args = (torch.zeros((), dtype=torch.int64), 4, "bits")
    elif case == "device":
        args = (keys.to("meta"), 4, "bits")
    elif case == "form":
        args = (keys, 4, "words")
    elif case == "count":
        args = (keys, 2**32 + 1, "bits")
    elif case == "base":
        args, kw = (keys, 2, "keys"), {"base": 2**32 - 1}
    else:
        args, kw = (keys, 4, "randint"), {"minval": 5, "maxval": 5}
    before = rng.threefry_launch.launches
    with pytest.raises(ValueError):
        rng.threefry_launch(*args, **kw)
    assert rng.threefry_launch.launches == before


@pytest.mark.parametrize("form,tail,dtype", [("keys", (2,), torch.int64),
                                             ("bits", (), torch.int64),
                                             ("uniform", (), torch.float32),
                                             ("randint", (), torch.int32)])
def test_an_empty_draw_is_empty_and_launches_nothing(form, tail, dtype):
    keys = torch_keys(key_data(15, 3))
    kw = {"minval": 0, "maxval": 7} if form == "randint" else {}
    before = rng.threefry_launch.launches
    for k, count, shape in [(keys, 0, (3, 0)), (keys[:0], 5, (0, 5))]:
        out = rng.threefry_launch(k, count, form, **kw)
        assert out.shape == shape + tail and out.dtype == dtype
    assert rng.random_bits(keys, (0, 4)).shape == (3, 0, 4)
    assert rng.threefry_launch.launches == before


def test_strided_and_broadcast_keys_draw_as_their_copies():
    """Slices of a split (the key chain's operands) and an expanded key
    give what their contiguous copies give."""
    keys = torch_keys(key_data(16, 5))
    pair = rng.split(keys, 3)
    for k in (pair[:, 1], pair[1:4, :, 0:2][:, 2], keys[0].expand(4, 2), pair.transpose(0, 1)):
        assert not k.is_contiguous()
        for draw in (lambda x: rng.split(x, 2), lambda x: rng.fold_in(x, 8),
                     lambda x: rng.uniform(x, (3,)), lambda x: rng.randint(x, (), 0, 85)):
            assert torch.equal(draw(k), draw(k.contiguous()))


def test_the_cells_steps_make_four_and_ten_hash_passes(monkeypatch):
    """A windy ``step_batched`` calls the hash pass 4 times and an Advanced
    ``stateless_step`` + ``conditional_reset`` 10 times: on the card, one
    kernel launch each (``threefry_launch.launches``)."""
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv
    from gymca_torch.envs.bulldozer import BulldozerCore

    calls = []
    launch = rng.threefry_launch

    def counted(*args, **kw):
        calls.append(args[2])
        return launch(*args, **kw)

    core = BulldozerCore(64, 64, device="cpu")  # one CA update a step at most
    states = core.initial_state(rng.split(rng.key(17, device="cpu"), 3))
    env = AdvancedForestFireBulldozerEnv(16, 16, key=rng.key(18, device="cpu"), num_envs=3,
                                         use_fused_ca=True, device="cpu")
    obs, info = env.reset()
    monkeypatch.setattr(rng, "threefry_launch", counted)
    core.step_batched(states, torch.tensor([[4, 1], [0, 0], [8, 1]], dtype=torch.int32))
    assert calls == ["keys", "keys", "keys", "uniform"]
    calls.clear()
    a = torch.tensor([[1, 1, 0], [4, 0, 0], [8, 1, 0]], dtype=torch.int32)
    env.conditional_reset(env.stateless_step(a, obs, info), a)
    assert calls == ["keys", "keys", "keys", "uniform", "randint",
                     "keys", "keys", "uniform", "keys", "randint"]
