"""Tests that need a CUDA device, and the K1 inputs the CPU tests share.

Run them where the card is with
``pytest --noconftest -m gpu tests/test_torch_gpu.py``: a GPU machine need
not have JAX, which ``tests/conftest.py`` and the other port tests import,
so this file imports only torch, numpy and the port.  Without a card each
test skips; whether a card exists is decided inside the ``cuda`` fixture.
"""

import numpy as np
import pytest
import torch

from gymca_torch.envs.bulldozer import BulldozerCore
from gymca_torch.ops import windy_kernel as wk

EMPTY, TREE, FIRE = 0, 3, 25


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_inputs(seed, n, h, w, dtype, k, classes):
    """K1 inputs from numpy: ``classes[e]`` is 'ca', 'modify' or 'idle'.  CA
    envs get deferred edits (some pending, some past the count).  Env e
    shoots, by e % 3, at a tree with no fire around it (a CA env hits it),
    at a fire, or at a tree beside a fire with every gust on (it burns
    first, so a CA env misses; a modify-only env still hits it)."""
    r = np.random.default_rng(seed)
    grid = r.choice(np.asarray([EMPTY, TREE, FIRE], dtype), size=(n, h, w),
                    p=(0.25, 0.6, 0.15))
    params = np.zeros((n, 4), np.int32)
    edits = np.zeros((n, k), np.int32)
    counts = np.zeros((n,), np.int32)
    for e, cls in enumerate(classes):
        row, col = int(r.integers(0, h)), int(r.integers(0, w))
        if e % 3 == 0:
            hood = grid[e, max(row - 1, 0):row + 2, max(col - 1, 0):col + 2]
            hood[hood == FIRE] = TREE
            grid[e, row, col] = TREE
        elif e % 3 == 1:
            grid[e, row, col] = FIRE
        else:
            grid[e, row, col] = TREE
            grid[e, row, col - 1 if col > 0 else col + 1] = FIRE
        params[e] = [cls == "ca", row, col, cls != "idle"]
        if cls == "ca" and k:
            rows, cols = r.integers(0, h, k), r.integers(0, w, k)
            edits[e] = rows | (cols << 16)
            counts[e] = int(r.integers(1, k + 1))
    weights = (r.integers(0, 2, (n, 8)) * 8).astype(np.int32)
    weights[2::3] = 8
    return grid, weights, params, edits, counts


def as_torch(inputs, device="cpu"):
    return [torch.tensor(x, device=device) for x in inputs]  # copies: K1 works in place


def run_plain(inputs):
    g, w, p, e, c = as_torch(inputs)
    return wk.windy_fused_step_plain(g, w, p, e, c, empty=EMPTY, tree=TREE, fire=FIRE)


def key_data(seed, n):
    kd = np.random.default_rng(seed).integers(0, 2**32, (n, 2), dtype=np.uint64)
    return kd.astype(np.int64)


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,w,dtype", [(64, 256, 256, np.int8), (16, 64, 128, np.int32),
                                         (16, 40, 50, np.int8), (8, 24, 36, np.int32),
                                         (6, 512, 512, np.int8)])  # > 48 KiB of masks
def test_kernel_matches_plain_on_the_card(cuda, n, h, w, dtype):
    classes = [("ca", "modify", "idle")[i % 3] for i in range(n)]
    inputs = make_inputs(6, n, h, w, dtype, 5, classes)
    g, wt, p, e, c = as_torch(inputs, cuda)
    before = wk.windy_fused_step.launches
    got, counts = wk.windy_fused_step(g, wt, p, e, c, empty=EMPTY, tree=TREE, fire=FIRE)
    torch.cuda.synchronize()
    assert wk.windy_fused_step.launches == before + 1
    want, want_counts = run_plain(inputs)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(counts.cpu().numpy(), want_counts.numpy())


@pytest.mark.gpu
def test_wrapper_rejects_grids_past_shared_memory(cuda):
    g = torch.zeros((1, 1024, 1024), dtype=torch.int8, device=cuda)
    w = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    p = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        wk.windy_fused_step(g, w, p, empty=EMPTY, tree=TREE, fire=FIRE)


@pytest.mark.gpu
def test_step_batched_on_the_card_matches_the_cpu(cuda):
    """The kernel path on the card against the plain path on the CPU, at the
    main path's grid size."""
    n, steps = 8, 12
    core_gpu, core_cpu = BulldozerCore(256, 256), BulldozerCore(256, 256, device="cpu")
    keys = torch.as_tensor(key_data(19, n))
    gpu, cpu = core_gpu.initial_state(keys.to(cuda)), core_cpu.initial_state(keys)
    r = np.random.default_rng(20)
    for i in range(steps):
        a = np.stack([r.integers(0, 9, n), r.integers(0, 2, n)], -1)
        a = torch.as_tensor(a.astype(np.int32))
        gpu, gout = core_gpu.step_batched(gpu, a.to(cuda))
        cpu, cout = core_cpu.step_batched(cpu, a)
        for x, y in [(gpu.grid, cpu.grid), (gout.reward, cout.reward),
                     (gout.info["hit"], cout.info["hit"]), (gpu.key, cpu.key)]:
            assert torch.equal(x.cpu(), y), i


@pytest.mark.gpu
def test_wrapper_rejects_inputs_off_the_grids_device(cuda):
    g, w, p, e, c = as_torch(make_inputs(7, 2, 8, 32, np.int8, 2, ("ca", "idle")), cuda)
    with pytest.raises(ValueError):
        wk.windy_fused_step(g, w.cpu(), p, e, c, empty=EMPTY, tree=TREE, fire=FIRE)


@pytest.mark.gpu
def test_entry_points_default_to_the_card(cuda):
    core = BulldozerCore(32, 128)
    assert core.device.type == "cuda"
    states = core.initial_state(torch.as_tensor(key_data(21, 2)))
    assert states.grid.device.type == "cuda"
