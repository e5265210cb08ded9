"""The port's public surface against the JAX package's, on the CPU.

Registration and ``gym.make`` (the port's ids under the ``gymca_torch/``
namespace, the JAX package's bare ids still making JAX envs in the same
process), gymnasium's ``env_checker``, the ``gymca`` catalog and
``compat`` names, ``GridSpace`` against the JAX ``GridSpace`` (the cases of
``tests/test_spaces.py``, same seed -> same samples), and ``moore_n`` /
``neighborhood_at`` against the JAX versions at corners, edges and radii
1-3.
"""

import warnings

import gymnasium as gym
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from gymnasium.spaces import flatdim, flatten, unflatten

import gymca_torch
import gymca_tpu
from gymca_torch import compat
from gymca_torch.gym_env import ForestFireBulldozerEnv, ForestFireHelicopterEnv, GridSpace
from gymca_torch.utils.neighbors import moore_n, neighborhood_at
from gymca_tpu import compat as j_compat
from gymca_tpu.core.gym_compat import GridSpace as JGridSpace
from gymca_tpu.envs.bulldozer import ForestFireBulldozerEnv as JBulldozerEnv
from gymca_tpu.envs.helicopter import ForestFireHelicopterEnv as JHelicopterEnv
from gymca_tpu.utils import neighbors as j_neighbors


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PORT_CLASSES = {"ForestFireHelicopter": ForestFireHelicopterEnv,
                "ForestFireBulldozer": ForestFireBulldozerEnv}
JAX_CLASSES = {"ForestFireHelicopter": JHelicopterEnv, "ForestFireBulldozer": JBulldozerEnv}


def family(env_id):
    return next(k for k in PORT_CLASSES if k in env_id)


# --- registration ---------------------------------------------------------------------


def test_catalog_parity():
    assert len(gymca_torch.gymca.envs) == len(gymca_tpu.gymca.envs) == 2
    assert len(gymca_torch.gymca.prototypes) == 3
    assert [p.__name__ for p in gymca_torch.gymca.prototypes] == [
        p.__name__ for p in gymca_tpu.gymca.prototypes]
    assert all(p.__module__.startswith("gymca_torch") for p in gymca_torch.gymca.prototypes)


def test_ids_are_apart_from_the_jax_ids():
    """Each port id is the JAX id under the ``gymca_torch/`` namespace, and
    ``GYM_MAKE`` names the module to import first."""
    assert {i.split("/", 1)[1] for i in gymca_torch.REGISTERED_CA_ENVS} == set(
        gymca_tpu.REGISTERED_CA_ENVS)
    assert not set(gymca_torch.REGISTERED_CA_ENVS) & set(gymca_tpu.REGISTERED_CA_ENVS)
    assert gymca_torch.GYM_MAKE == tuple(f"gymca_torch:{i}"
                                         for i in gymca_torch.REGISTERED_CA_ENVS)


@pytest.mark.parametrize("env_id", sorted(gymca_torch.REGISTERED_CA_ENVS))
def test_gym_make_builds_port_envs(env_id):
    env = gym.make(env_id, device="cpu").unwrapped
    assert type(env) is PORT_CLASSES[family(env_id)]
    assert env.core.device == torch.device("cpu")
    assert (env.nrows, env.ncols) == tuple(gymca_torch.REGISTERED_CA_ENVS[env_id]["kwargs"]
                                           .values())
    made = gym.make(f"gymca_torch:{env_id}", device="cpu").unwrapped
    assert type(made) is type(env)


@pytest.mark.parametrize("env_id", sorted(gymca_tpu.REGISTERED_CA_ENVS))
def test_jax_ids_still_make_jax_envs(env_id):
    """Both packages are imported here (and re-registering the port changes
    nothing): the JAX ids keep their JAX classes."""
    gymca_torch.registration._register_caenvs()
    assert type(gym.make(env_id).unwrapped) is JAX_CLASSES[family(env_id)]


@pytest.mark.parametrize("env_id", sorted(gymca_torch.REGISTERED_CA_ENVS))
def test_env_checker(env_id):
    """gymnasium's own API contract checker on each registered port env."""
    from gymnasium.utils.env_checker import check_env

    env = gym.make(env_id, device="cpu").unwrapped
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # cosmetic render_mode warnings
        check_env(env, skip_render_check=True)


def test_spaces_match_the_jax_envs():
    for port, jax_cls in ((ForestFireHelicopterEnv(9, 11, device="cpu"), JHelicopterEnv),
                          (ForestFireBulldozerEnv(12, 16, device="cpu"), JBulldozerEnv)):
        want = jax_cls(*(port.nrows, port.ncols))
        assert repr(port.observation_space) == repr(want.observation_space)
        assert repr(port.action_space) == repr(want.action_space)


def test_public_names():
    for name in ("CAEnvCore", "EnvState", "StepOutput", "GymCAEnv", "autoreset_step",
                 "Operator", "Identity", "GridSpace", "GridSpec", "BoxSpec", "DiscreteSpec",
                 "MultiDiscreteSpec", "TupleSpec", "DictSpec", "gymca", "REGISTERED_CA_ENVS",
                 "GYM_MAKE"):
        assert name in gymca_torch.__all__ and name in gymca_tpu.__all__
        assert getattr(gymca_torch, name) is not None
    assert gymca_torch.__version__ == gymca_tpu.__version__
    assert gymca_torch.RELEASE is False
    assert gymca_torch.GridSpace is GridSpace
    with pytest.raises(AttributeError):
        gymca_torch.NoSuchName  # noqa: B018


def test_compat_names():
    assert set(compat.__all__) == set(j_compat.__all__)
    for name in compat.__all__:
        got = getattr(compat, name)
        want = getattr(j_compat, name)
        if isinstance(want, type):
            assert got.__name__ == want.__name__ or name == "CAEnv"
            assert got.__module__.startswith("gymca_torch")
    assert compat.PartiallyObservableForestFireJax.__name__ == "AlexandridisCA"
    assert compat.envs == gymca_torch.GYM_MAKE and len(compat.prototypes) == 3


# --- GridSpace (tests/test_spaces.py's cases) ------------------------------------------


def test_gridspace_contains_its_samples():
    space = GridSpace(values=[0, 3, 25], shape=(5, 5), seed=7)
    for _ in range(8):
        assert space.contains(space.sample())
    assert not space.contains(np.full((5, 5), 4)) and not space.contains("grid")


@pytest.mark.parametrize("kw", [dict(n=3, shape=(4, 4)),
                                dict(values=[0, 3, 25], shape=(5, 3), probs=[0.1, 0.9, 0.0]),
                                dict(values=[2, 1], shape=(6,), dtype=np.int8)])
def test_gridspace_samples_as_the_jax_gridspace(kw):
    for seed in range(4):
        a, b, j = GridSpace(**kw, seed=seed), GridSpace(**kw, seed=seed), JGridSpace(**kw,
                                                                                   seed=seed)
        for _ in range(3):
            x, y, z = a.sample(), b.sample(), j.sample()
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
            assert x.dtype == z.dtype
    port, want = GridSpace(**kw), JGridSpace(**kw)
    assert repr(port) == repr(want)
    assert (port.n, port.size, port.shape, port.dtype) == (want.n, want.size, want.shape,
                                                           want.dtype)
    np.testing.assert_array_equal(port.values, want.values)
    np.testing.assert_array_equal(port.probs, want.probs)
    assert port.is_np_flattenable


def test_gridspace_equality():
    assert GridSpace(n=3, shape=(2, 2)) == GridSpace(values=[0, 1, 2], shape=(2, 2))
    assert GridSpace(n=3, shape=(2, 2)) != GridSpace(n=4, shape=(2, 2))
    assert GridSpace(n=3, shape=(2, 2)) != JGridSpace(n=3, shape=(2, 2))
    assert repr(GridSpace(n=3, shape=(2, 2))) == "GridSpace(n=3, shape=(2, 2))"


def test_gridspace_flatten():
    space, want = GridSpace(n=3, shape=(2, 3), seed=0), JGridSpace(n=3, shape=(2, 3), seed=0)
    x = space.sample()
    flat = flatten(space, x)
    assert flat.shape == (6,) and flatdim(space) == flatdim(want) == 6
    np.testing.assert_array_equal(flat, flatten(want, x))
    back = unflatten(space, flat)
    np.testing.assert_array_equal(back, x)
    assert back.dtype == space.dtype


def test_gridspace_from_spec():
    env = ForestFireBulldozerEnv(8, 8, device="cpu")
    space = GridSpace.from_spec(env.core.grid_spec)
    assert space == env.observation_space[0]
    assert repr(space) == repr(JBulldozerEnv(8, 8).observation_space[0])
    assert space.dtype == np.int8


def test_gridspace_requires_values_or_n():
    with pytest.raises(ValueError):
        GridSpace(shape=(2, 2))


# --- utils/neighbors ------------------------------------------------------------------

POSITIONS = [(0, 0), (0, 6), (8, 0), (8, 6), (0, 3), (4, 0), (8, 3), (4, 6), (4, 3)]


@pytest.mark.parametrize("n", [1, 2, 3])
def test_moore_n_matches_jax(n):
    grid = np.random.default_rng(n).integers(0, 50, (9, 7)).astype(np.int32)
    for pos in POSITIONS:
        want = np.asarray(j_neighbors.moore_n(n, pos, jnp.asarray(grid), invariant=-1))
        got = moore_n(n, pos, torch.tensor(grid), invariant=-1)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(pos))
        tensor_pos = moore_n(n, torch.tensor(pos), torch.tensor(grid), invariant=-1)
        np.testing.assert_array_equal(tensor_pos.numpy(), want)


def test_moore_n_clamps_as_dynamic_slice():
    grid = np.arange(30, dtype=np.int32).reshape(5, 6)
    for pos in [(-2, 3), (7, 9), (2, -1)]:
        want = np.asarray(j_neighbors.moore_n(1, pos, jnp.asarray(grid)))
        np.testing.assert_array_equal(moore_n(1, pos, torch.tensor(grid)).numpy(), want)


def test_neighborhood_at_matches_jax():
    grid = np.random.default_rng(0).integers(0, 3, (6, 5)).astype(np.int32)
    for pos in [(0, 0), (5, 4), (2, 2), (0, 4)]:
        want = j_neighbors.neighborhood_at(jnp.asarray(grid), pos, invariant=9)
        got = neighborhood_at(torch.tensor(grid), pos, invariant=9)
        assert got._fields == want._fields
        assert [int(v) for v in got] == [int(v) for v in want]
