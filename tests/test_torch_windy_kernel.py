"""K1: the plain version against the JAX kernel, the wrapper's contract, and
its contract on the CPU.  The CUDA kernel itself is held to the plain version
in ``tests/test_torch_gpu.py`` (``test_windy_kernel_on_band_seams_and_one_class_matches_plain``
and the recorded launches of ``test_windy_main_path_on_the_card``).

The JAX kernel runs in Pallas interpret mode on the CPU, at the sizes
``tests/test_pallas.py`` uses.  Every comparison is exact (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymca_torch.ops import windy_kernel as wk
from gymca_torch.ops.stencil import NEIGHBOR_OFFSETS
from test_torch_gpu import EMPTY, FIRE, TREE, as_torch, make_inputs, run_plain
from gymca_tpu.ops.pallas_kernels import windy_fused_step as jax_windy_fused_step
from gymca_tpu.ops.windy import windy_step_from_success

@pytest.mark.parametrize("n,h,w,dtype,classes", [
    (3, 16, 128, np.int32, ("modify", "idle", "ca")),
    (2, 32, 128, np.int8, ("ca", "modify")),
])
def test_plain_matches_jax_kernel(n, h, w, dtype, classes):
    inputs = make_inputs(1, n, h, w, dtype, 4, classes)
    want_grid, want_counts = jax_windy_fused_step(
        *[jnp.asarray(x) for x in inputs], empty=EMPTY, tree=TREE, fire=FIRE,
        interpret=True)
    got_grid, got_counts = run_plain(inputs)
    np.testing.assert_array_equal(got_grid.numpy(), np.asarray(want_grid))
    want_counts = np.asarray(want_counts)
    for e, cls in enumerate(classes):
        if cls == "ca":
            np.testing.assert_array_equal(got_counts[e].numpy(), want_counts[e])
        elif cls == "modify":  # only the hit is defined for modify rows
            assert int(got_counts[e, 2]) == int(want_counts[e, 2])
    assert int(got_counts[:, 2].sum()) >= 1  # some shot hit a tree


@pytest.mark.parametrize("h,w,dtype", [(8, 40, np.int8), (12, 64, np.int32)])
def test_plain_is_replay_then_windy_rule_then_shot(h, w, dtype):
    """The plain version equals the JAX rule ``windy_step_from_success``
    applied after the edits, with the shot on the new grid."""
    n = 6
    classes = ["ca", "ca", "ca", "modify", "idle", "ca"]
    inputs = make_inputs(2, n, h, w, dtype, 3, classes)
    grid, weights, params, edits, counts = inputs
    got_grid, got_counts = run_plain(inputs)
    for e, cls in enumerate(classes):
        g = grid[e].astype(np.int32)
        row, col = params[e, 1], params[e, 2]
        if cls == "ca":
            for wrd in edits[e, :counts[e]]:
                g[wrd & 0xFFFF, wrd >> 16] = EMPTY
            success = np.zeros((3, 3), bool)
            for i, (dr, dc) in enumerate(NEIGHBOR_OFFSETS):
                success[1 - dr, 1 - dc] = weights[e, i] > 0
            new = np.array(windy_step_from_success(
                jnp.asarray(g), jnp.asarray(success), empty=EMPTY, tree=TREE, fire=FIRE))
            hit = int(new[row, col] == TREE)
            if hit:
                new[row, col] = EMPTY
            want = [(new == TREE).sum(), (new == FIRE).sum(), hit]
        elif cls == "modify":
            hit = int(g[row, col] == TREE)
            new = g.copy()
            if hit:
                new[row, col] = EMPTY
            want = [0, 0, hit]
        else:
            new, want = g, [0, 0, 0]
        np.testing.assert_array_equal(got_grid[e].numpy(), new.astype(dtype))
        np.testing.assert_array_equal(got_counts[e].numpy(), want)


def test_wrapper_on_cpu_takes_the_plain_version_in_place():
    inputs = make_inputs(3, 4, 16, 32, np.int8, 2, ("ca", "modify", "idle", "ca"))
    g, w, p, e, c = as_torch(inputs)
    before = wk.windy_fused_step.launches
    out, counts = wk.windy_fused_step(g, w, p, e, c, empty=EMPTY, tree=TREE, fire=FIRE)
    assert out is g
    assert wk.windy_fused_step.launches == before  # no kernel on the CPU
    want_grid, want_counts = run_plain(inputs)
    np.testing.assert_array_equal(out.numpy(), want_grid.numpy())
    np.testing.assert_array_equal(counts.numpy(), want_counts.numpy())
    assert counts.dtype == torch.int32 and counts.shape == (4, 3)


def test_wrapper_without_edits_matches_empty_log():
    inputs = make_inputs(4, 3, 8, 32, np.int32, 0, ("ca", "ca", "modify"))
    g, w, p, _, _ = as_torch(inputs)
    got, counts = wk.windy_fused_step(g.clone(), w, p, empty=EMPTY, tree=TREE, fire=FIRE)
    want, want_counts = run_plain(inputs)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(counts.numpy(), want_counts.numpy())


@pytest.mark.parametrize("bad", ["dtype", "weights_shape", "params_dtype", "noncontig",
                                 "edit_counts_shape", "encoding", "fit"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    g, w, p, e, c = as_torch(make_inputs(5, 2, 8, 32, np.int8, 2, ("ca", "idle")))
    kw = dict(empty=EMPTY, tree=TREE, fire=FIRE)
    if bad == "dtype":
        g = g.to(torch.int16)
    elif bad == "weights_shape":
        w = w[:, :7].contiguous()
    elif bad == "params_dtype":
        p = p.long()
    elif bad == "noncontig":
        g = g.transpose(1, 2)
    elif bad == "edit_counts_shape":
        c = c[:1]
    elif bad == "encoding":
        kw = dict(empty=0, tree=3, fire=4)
    elif bad == "fit":
        kw = dict(empty=0, tree=5, fire=130)  # a valid encoding past int8
    with pytest.raises(ValueError):
        wk.windy_fused_step(g, w, p, e, c, **kw)


def test_shared_memory_bytes():
    """A CA-pass block stages its row band (ceil(H / 4) rows) and a halo row
    each side as two bit masks."""
    assert wk.CLUSTER_BLOCKS == 4
    assert wk.shared_memory_bytes(256, 256) == 2 * 4 * (64 + 2) * 8
    assert wk.shared_memory_bytes(40, 50) == 2 * 4 * (10 + 2) * 2
    assert wk.shared_memory_bytes(3, 64) == 2 * 4 * (1 + 2) * 2
    # the card's cases that need the opt-in past 48 KiB a block
    assert wk.shared_memory_bytes(1024, 1024) == 2 * 4 * (256 + 2) * 32 > 48 * 1024


def test_scratch_is_zero_and_made_once_per_stream_and_size():
    a = wk._scratch_for(5, torch.device("cpu"), 0)
    assert a.dtype == torch.int32 and a.shape == (7,) and not a.any()
    assert wk._scratch_for(5, torch.device("cpu"), 0) is a
    assert wk._scratch_for(5, torch.device("cpu"), 1) is not a
    assert wk._scratch_for(6, torch.device("cpu"), 0).shape == (8,)


def band_step(inputs):
    """The CA pass's partition emulated on the CPU: each of the
    ``CLUSTER_BLOCKS`` blocks of an env stages rows [r0 - 1, r1 + 1) of the
    grid as it was, replays the edits that fall in them, and steps its band
    [r0, r1) from that copy alone; counts are the bands' sums."""
    grid, weights, params, edits, edit_counts = (torch.tensor(x) for x in inputs)
    n, h, w = grid.shape
    out = grid.clone().to(torch.int32)
    counts = torch.zeros((n, 3), dtype=torch.int32)
    band = -(-h // wk.CLUSTER_BLOCKS)
    success = torch.zeros((n, 3, 3), dtype=torch.bool)
    for i, (dr, dc) in enumerate(NEIGHBOR_OFFSETS):
        success[:, 1 - dr, 1 - dc] = weights[:, i] > 0
    for e in range(n):
        do_ca, row, col, shoot = (int(v) for v in params[e])
        if not do_ca:
            if shoot and out[e, row, col] == TREE:
                out[e, row, col] = EMPTY
                counts[e, 2] = 1
            continue
        for rank in range(wk.CLUSTER_BLOCKS):
            r0 = min(rank * band, h)
            r1 = min(r0 + band, h)
            rs, re = max(r0 - 1, 0), min(r1 + 1, h)
            staged = grid[e, rs:re].to(torch.int32).clone()
            for wrd in edits[e, :min(int(edit_counts[e]), edits.shape[1])].tolist():
                r, c = wrd & 0xFFFF, wrd >> 16
                if rs <= r < re and 0 <= c < w:
                    staged[r - rs, c] = EMPTY
            new = wk.windy_step_from_success(staged[None], success[e:e + 1], empty=EMPTY,
                                             tree=TREE, fire=FIRE)[0][r0 - rs:r1 - rs]
            if shoot and r0 <= row < r1 and new[row - r0, col] == TREE:
                new[row - r0, col] = EMPTY
                counts[e, 2] = 1
            out[e, r0:r1] = new
            counts[e, 0] += int((new == TREE).sum())
            counts[e, 1] += int((new == FIRE).sum())
    return out, counts


@pytest.mark.parametrize("n,h,w,dtype", [(9, 64, 64, np.int8), (6, 40, 50, np.int32),
                                         (6, 3, 64, np.int8), (6, 33, 96, np.int8)])
def test_band_partition_equals_the_plain_version(n, h, w, dtype):
    """Bands, halo rows and edits in halo rows as the CA pass cuts them:
    together they give the plain version's grid and counts."""
    inputs = make_inputs(7, n, h, w, dtype, 5, ["ca", "modify", "idle"] * (n // 3))
    got_grid, got_counts = band_step(inputs)
    want_grid, want_counts = run_plain(inputs)
    np.testing.assert_array_equal(got_grid.numpy(), want_grid.numpy().astype(np.int32))
    np.testing.assert_array_equal(got_counts.numpy(), want_counts.numpy())


def test_build_of_a_missing_source_raises():
    from gymca_torch import _build

    with pytest.raises(RuntimeError, match="checkout"):
        _build.build(["no_such_kernel"])
