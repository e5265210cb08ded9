"""The legacy SEQUENTIAL Alexandridis prototype of the port against the JAX
package's: ``tests/test_alexandridis_legacy.py``'s rule tests on the port,
and the port's class equal to the JAX package's cell for cell from the same
``np.random.Generator`` seed (tolerance 0; both are NumPy on the host).
Inputs reach the port as tensors where the tests say so: it reads them back
to the host."""

import numpy as np
import pytest
import torch

from gymca_torch.ops.alexandridis import AlexandridisCA
from gymca_torch.ops.alexandridis_legacy import SequentialAlexandridisCA
from gymca_tpu.ops.alexandridis_legacy import SequentialAlexandridisCA as JaxPackageCA

EMPTY, TREE, FIRE = 0, 1, 2
H = W = 8


def make_context(p_tree=0.0, p_wind_change=0.0, veg=5, den=5, slope=0.0, fire_age=None):
    wind = np.ones((3, 3))
    wind[1, 1] = 0.0
    ft = np.zeros((3, 3))  # zero thrust => pinecones never travel
    return {
        "winds": [(wind, ft)] * 8,
        "wind_index": 0,
        "density": np.full((H, W), den, np.int32),
        "vegetation": np.full((H, W), veg, np.int32),
        "slope": np.full((H, W), slope),
        "altitude": np.zeros((H, W)),
        "fire_age": np.zeros((H, W), np.int64) if fire_age is None else fire_age,
        "p_tree": p_tree,
        "p_wind_change": p_wind_change,
    }


def test_factory():
    op = AlexandridisCA.sequential_prototype(EMPTY, TREE, FIRE)
    assert isinstance(op, SequentialAlexandridisCA)


def test_tree_with_fire_neighbor_ignites_at_max_terrain():
    """veg=den=5, flat slope, wind=1 everywhere: p_burn = .58*2*2 = 2.32 > 1,
    so every tree next to the fire ignites with fire_age in [4, 10]; the
    grid arrives as a tensor."""
    op = SequentialAlexandridisCA(EMPTY, TREE, FIRE, rng=np.random.default_rng(3))
    grid = np.full((H, W), TREE, np.int64)
    grid[4, 4] = FIRE
    fa = np.zeros((H, W), np.int64)
    fa[4, 4] = 5
    new, ctx2 = op.update(torch.from_numpy(grid), make_context(fire_age=fa))
    for r in range(3, 6):
        for c in range(3, 6):
            if (r, c) != (4, 4):
                assert new[r, c] == FIRE, (r, c)
                assert 4 <= ctx2["fire_age"][r, c] <= 10
    assert new[1, 1] == TREE and new[6, 7] == TREE


def test_tree_never_ignites_at_hostile_terrain():
    """veg=den=1 and wind 0: never."""
    op = SequentialAlexandridisCA(EMPTY, TREE, FIRE, rng=np.random.default_rng(5))
    grid = np.full((H, W), TREE, np.int64)
    grid[4, 4] = FIRE
    fa = np.zeros((H, W), np.int64)
    fa[4, 4] = 9
    ctx = make_context(veg=1, den=1, fire_age=fa)
    ctx["winds"] = [(np.zeros((3, 3)), np.zeros((3, 3)))] * 8
    new, _ = op.update(grid, ctx)
    assert (new == FIRE).sum() == 1


def test_fire_burns_out_when_age_expires():
    op = SequentialAlexandridisCA(EMPTY, TREE, FIRE, rng=np.random.default_rng(0))
    grid = np.full((H, W), EMPTY, np.int64)
    grid[2, 2] = FIRE
    grid[5, 5] = FIRE
    fa = np.zeros((H, W), np.int64)
    fa[2, 2] = 1
    fa[5, 5] = 3
    new, ctx2 = op.update(grid, make_context(fire_age=torch.from_numpy(fa)))
    assert new[2, 2] == EMPTY
    assert new[5, 5] == FIRE
    assert ctx2["fire_age"][5, 5] == 2


def test_empty_growth_probability_extremes():
    op = SequentialAlexandridisCA(EMPTY, TREE, FIRE, rng=np.random.default_rng(1))
    grid = np.full((H, W), EMPTY, np.int64)
    new, _ = op.update(grid, make_context(p_tree=1.0))
    assert (new == TREE).all()
    new, _ = op.update(grid, make_context(p_tree=0.0))
    assert (new == EMPTY).all()


def test_wind_rotation():
    op = SequentialAlexandridisCA(EMPTY, TREE, FIRE, rng=np.random.default_rng(2))
    grid = np.full((H, W), EMPTY, np.int64)
    _, ctx2 = op.update(grid, make_context(p_wind_change=1.0))
    assert ctx2["wind_index"] != 0
    _, ctx3 = op.update(grid, make_context(p_wind_change=0.0))
    assert ctx3["wind_index"] == 0


def test_pinecone_spotting_and_skip_semantics():
    """Strong thrust, no wind: fires spot pinecones onto distant cells within
    40 passes; a spotted cell keeps its sampled age."""
    op = SequentialAlexandridisCA(EMPTY, TREE, FIRE, rng=np.random.default_rng(11))
    grid = np.full((H, W), TREE, np.int64)
    grid[0, 0] = FIRE
    fa = np.zeros((H, W), np.int64)
    fa[0, 0] = 50
    ctx = make_context(veg=5, den=5, fire_age=fa)
    ctx["winds"] = [(np.zeros((3, 3)), np.full((3, 3), 2.0))] * 8
    spotted = False
    for _ in range(40):
        grid, ctx = op.update(grid, ctx)
        if any((abs(r) + abs(c)) > 2 for r, c in np.argwhere(grid == FIRE)):
            spotted = True
            break
    assert spotted, "pinecones never spotted within 40 steps"
    assert (ctx["fire_age"][grid == FIRE] >= 1).all()


@pytest.mark.parametrize("seed", [0, 7])
def test_equals_the_jax_package_class_cell_for_cell(seed):
    """Five passes over a 16 x 12 grid with random terrain, burning cells,
    growth, wind changes and strong pinecone thrust, from one Generator seed
    on each side: grid, fire age and wind index equal after every pass.  The
    port gets its arrays as tensors."""
    r = np.random.default_rng(100 + seed)
    h, w = 16, 12
    grid = r.choice(np.asarray([EMPTY, TREE, TREE, FIRE]), (h, w)).astype(np.int64)
    winds = [(r.uniform(0, 1.2, (3, 3)), r.uniform(0, 2.5, (3, 3))) for _ in range(8)]
    ctx = {
        "winds": winds,
        "wind_index": 3,
        "density": r.integers(1, 6, (h, w)).astype(np.int32),
        "vegetation": r.integers(1, 6, (h, w)).astype(np.int32),
        "slope": r.uniform(-20, 20, (h, w)),
        "fire_age": r.integers(1, 8, (h, w)).astype(np.int64),
        "p_tree": 0.05,
        "p_wind_change": 0.3,
    }
    ref = JaxPackageCA(EMPTY, TREE, FIRE, rng=np.random.default_rng(seed))
    port = SequentialAlexandridisCA(EMPTY, TREE, FIRE, rng=np.random.default_rng(seed))
    j_grid, j_ctx = grid, dict(ctx)
    t_grid = torch.from_numpy(grid)
    t_ctx = {**ctx, **{k: torch.from_numpy(np.asarray(ctx[k]))
                       for k in ("density", "vegetation", "slope", "fire_age")},
             "winds": [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in winds]}
    changed = 0
    for step in range(5):
        j_grid, j_ctx = ref.update(j_grid, j_ctx)
        t_grid, t_ctx = port.update(t_grid, t_ctx)
        np.testing.assert_array_equal(t_grid, j_grid, err_msg=str(step))
        np.testing.assert_array_equal(t_ctx["fire_age"], j_ctx["fire_age"], err_msg=str(step))
        assert t_ctx["wind_index"] == j_ctx["wind_index"]
        changed += int((j_grid != grid).sum())
    assert changed > 0
    # both Generators consumed the same draws
    assert ref.rng.integers(0, 2**32) == port.rng.integers(0, 2**32)
