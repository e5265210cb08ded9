"""The port's card-side checks, and the K1 inputs the CPU tests share.

Run them where the card is with
``pytest --noconftest -m gpu tests/test_torch_gpu.py``: a GPU machine need
not have JAX, which ``tests/conftest.py`` and the other port tests import,
so this file imports only torch, numpy and the port.  Without a card each
test skips; whether a card exists is decided inside the ``cuda`` fixture.
They hold every hand-written kernel to its plain version, drive the main
paths at the cells' sizes (4096 windy envs and 64 Advanced envs at 256²,
the trainer at ``scripts/run``'s defaults) with no host sync and their
launches counted, hold the card to the CPU, and run every entry point of
the port on the card.  Times are the entry points' and ``benchmark/``'s.
"""

import contextlib
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from gymca_torch import rng
from gymca_torch.envs.advanced import TERRAIN_KEYS, AdvancedForestFireBulldozerEnv
from gymca_torch.envs.bulldozer import BulldozerCore
from gymca_torch.ops import alexandridis_kernel as ak
from gymca_torch.ops import windy_kernel as wk
from gymca_torch.ops.alexandridis import AlexandridisCA
from gymca_torch.ops.stencil import telescoped_box_coeffs
from gymca_torch.probes import kernel_inputs as ki
from gymca_torch.probes.timing import sync_errors

EMPTY, TREE, FIRE = 0, 3, 25


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# Cases that run in a process of their own, by group, beside the main one:
# "profiler", the cases that read the profiler's events (late in a long
# process the profiler keeps no kernel event of a short session on any
# retry of ``profile_steps`` or ``time_launches``; PR 11 saw it first), and
# "host", the longest host-bound cases, so that the suite takes about the
# longest of the processes' times.
OWN_PROCESS, GROUPS = "GYMCA_TORCH_OWN_PROCESS", {"profiler": [], "host": []}


def own_process(group):
    """Runs the test in the process of ``group``, which ``own_processes``
    starts; it skips in every other process."""
    def mark(test):
        GROUPS[group].append(test.__name__)
        return pytest.mark.skipif(os.environ.get(OWN_PROCESS) != group,
                                  reason=f"runs in the {group} process, beside this one "
                                         "(test_cases_of_the_own_processes_pass)")(test)
    return mark


@pytest.fixture(scope="module", autouse=True)
def own_processes(request):
    """A pytest process for each group of ``own_process`` cases, started
    before the module's first test so that they run beside the others
    (nothing in any is timed against a bound), as ``{group: (process, its
    output file)}``; None in those processes, without a card, or when
    ``test_cases_of_the_own_processes_pass`` is not selected."""
    import subprocess
    import sys
    import tempfile

    wanted = any(i.name == "test_cases_of_the_own_processes_pass"
                 for i in request.session.items)
    if not wanted or OWN_PROCESS in os.environ or not torch.cuda.is_available():
        yield None
        return
    here = Path(__file__).resolve()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for group, names in GROUPS.items():
            out = open(Path(tmp) / f"{group}.txt", "w+b")
            procs[group] = (subprocess.Popen(
                [sys.executable, "-m", "pytest", "--noconftest", "-q", "-p", "no:cacheprovider",
                 "--basetemp", str(Path(tmp) / group), "-m", "gpu", "-k", " or ".join(names),
                 str(here)], cwd=here.parents[1], stdout=out, stderr=subprocess.STDOUT,
                env={**os.environ, OWN_PROCESS: group}), out)
        yield procs
        for proc, out in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()


@contextlib.contextmanager
def no_host_sync():
    """Inside the block, any wait of the host for the card raises."""
    torch.cuda.synchronize()
    with sync_errors("cuda"):
        yield


def windy_equals_plain(args, kw):
    """K1 and its plain version on copies of one launch's recorded inputs."""
    grid, *rest = args
    got = wk.windy_fused_step(grid.clone(), *rest, **kw)
    want = wk.windy_fused_step_plain(grid.clone(), *rest, **kw)
    return all(torch.equal(a, b) for a, b in zip(got, want))


def alexandridis_equals_plain(x, kw):
    """K2 and its plain version on one launch's recorded inputs: grid and
    age bit for bit (a NaN age is unequal)."""
    got = ak.alexandridis_fused_step(**x, **kw)
    want = ak.alexandridis_fused_step_plain(**x, **kw)
    return all(torch.equal(a, b) for a, b in zip(got, want))


@contextlib.contextmanager
def k2_launched(count, keep):
    """Inside the block K2 launches ``count`` times, and at the Advanced
    env's launches ``keep`` (indices in the block) equals its plain
    version."""
    before = ak.alexandridis_fused_step.launches
    with ki.alexandridis_recorder(keep) as recorded:
        yield
    assert ak.alexandridis_fused_step.launches - before == count
    assert len(recorded) == len(keep) and all(alexandridis_equals_plain(*r) for r in recorded)


@contextlib.contextmanager
def k2_each_env_step(steps, eager=0, check=False):
    """Inside the block the trainers' rollouts step their envs ``steps``
    times and run K2 once a step, and ``eager`` K2 launches are made outside
    the trainer (the BC warm-start's env steps).

    On the card a rollout step is a replay of a step graph, whose kernels
    the host launches only at the graph's warm-ups and capture.  So each
    call of the env half (``PPOTrainer._env_step``: a warm-up, a capture or
    an eager step) launches K2 once, the block's K2 launches are those
    calls' and ``eager``'s, and the step graphs replay ``steps`` times,
    each replay running the one K2 launch its capture recorded.  With
    ``check``, K2 equals its plain version at the block's first launch and
    at each capture's: the recorder's copies of a capture's inputs are
    captured with it, so after the block they hold the last replayed
    step's."""
    from gymca_torch.agents.ppo import PPOTrainer

    real_step, real_rollout = PPOTrainer._env_step, PPOTrainer.rollout
    calls, trainers = [], {}

    def env_step(self, *args):
        before = ak.alexandridis_fused_step.launches
        out = real_step(self, *args)
        calls.append((torch.cuda.is_current_stream_capturing(),
                      ak.alexandridis_fused_step.launches - before))
        return out

    def rollout(self, *args, **kw):
        trainers.setdefault(id(self), (self, self.step_graph_replays))
        return real_rollout(self, *args, **kw)

    def keep(i, args, kw):
        return i == 0 or torch.cuda.is_current_stream_capturing()

    before = ak.alexandridis_fused_step.launches
    PPOTrainer._env_step, PPOTrainer.rollout = env_step, rollout
    try:
        with (ki.alexandridis_recorder(keep) if check else contextlib.nullcontext([])) as kept:
            yield
    finally:
        PPOTrainer._env_step, PPOTrainer.rollout = real_step, real_rollout
    assert all(n == 1 for _, n in calls)
    assert ak.alexandridis_fused_step.launches - before == len(calls) + eager
    assert sum(t.step_graph_replays - r for t, r in trainers.values()) == steps
    if check:
        assert len(kept) == 1 + sum(c for c, _ in calls)
        assert all(alexandridis_equals_plain(*r) for r in kept)


def finite_metrics(history):
    return all(math.isfinite(v) for h in history for v in h.values())


def params_equal(a, b, groups=None):
    return all(torch.equal(a[g][k], b[g][k]) for g in (groups or a) for k in a[g])


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
                                         (6, 512, 512, np.int8),
                                         (2, 1024, 1024, np.int8),  # > 48 KiB of masks
                                         (2, 1024, 1024, np.int32)])
def test_kernel_matches_plain_on_the_card(cuda, n, h, w, dtype):
    classes = [("ca", "modify", "idle")[i % 3] for i in range(n)]
    inputs = make_inputs(6, n, h, w, dtype, 5, classes)
    g, wt, p, e, c = as_torch(inputs, cuda)
    if h == 1024:  # the band masks pass the 48 KiB a block gets without opting in
        assert wk.shared_memory_bytes(h, w) > 48 * 1024
    before = wk.windy_fused_step.launches
    got, counts = wk.windy_fused_step(g, wt, p, e, c, empty=EMPTY, tree=TREE, fire=FIRE)
    torch.cuda.synchronize()
    assert wk.windy_fused_step.launches == before + 1
    want, want_counts = run_plain(inputs)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(counts.cpu().numpy(), want_counts.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("classes,seams", [("mixed", False), ("mixed", True), ("ca", True),
                                           ("ca", False), ("idle", False), ("modify", False)])
@pytest.mark.parametrize("n,h,w,dtype", [(4096, 256, 256, torch.int8), (256, 256, 256, torch.int8),
                                         (64, 64, 128, torch.int32), (64, 40, 50, torch.int8),
                                         (16, 3, 64, torch.int8), (8, 512, 512, torch.int8),
                                         (2, 1024, 1024, torch.int8),
                                         (2, 1024, 1024, torch.int32)])
def test_windy_kernel_on_band_seams_and_one_class_matches_plain(cuda, classes, seams, n, h, w,
                                                                dtype):
    """The CA pass's band seams (fire on both sides; edits, including halo
    rows', and shots on a band's first and last row) and batches of one env
    class, on int8 and int32 rows and rows of the cell-per-lane width, at
    the windy cell's 4096 envs and its edit log of 11, bands of one row and
    band masks past 48 KiB; twice in a row, since the kernel's scratch must
    come back to zero."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(41)
    g, w_, p, e, c = ki.windy_inputs(n, h, w, dtype, 11, gen, device=cuda, classes=classes,
                                     seams=seams)
    for _ in range(2):
        got = wk.windy_fused_step(g.clone(), w_, p, e, c, empty=EMPTY, tree=TREE, fire=FIRE)
        want = wk.windy_fused_step_plain(g.clone(), w_, p, e, c, empty=EMPTY, tree=TREE,
                                         fire=FIRE)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_wrapper_rejects_grids_past_shared_memory(cuda):
    """A CA-pass block holds a row band (H / 4 rows and two halo rows) as
    two bit masks: 66 rows of 1023 words pass the 227 KiB a block may use."""
    assert wk.shared_memory_bytes(256, 32736) > 232448
    g = torch.zeros((1, 256, 32736), dtype=torch.int8, device=cuda)
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
def test_windy_main_path_on_the_card(cuda):
    """The windy cell's path, 4096 x 256² x 200 steps with no host sync: K1
    once a step, four threefry launches a step, finite rewards; K1 equal to
    its plain version where the steps ended; ``step_batched`` against the
    eager ``step`` on 64 envs x 100 steps, every output and leaf."""
    import gymca_torch.envs.bulldozer as bulldozer

    core, n = BulldozerCore(256, 256), 4096
    keys = rng.split(rng.key(0), n)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    counters = (wk.windy_fused_step, ak.alexandridis_fused_step, rng.threefry_launch)
    states = core.initial_state(keys)
    before = [c.launches for c in counters]
    with no_host_sync():
        states, out = ki.run_steps(core, states, ki.draw_actions(gen, 200, n))
    assert [c.launches - b for c, b in zip(counters, before)] == [200, 0, 800]
    assert out.reward.shape == (n,) and torch.isfinite(out.reward).all()
    with ki.launch_recorder(bulldozer, "windy_fused_step") as recorded:
        ki.run_steps(core, states, ki.draw_actions(gen, 3, n))
    assert len(recorded) == 3 and all(windy_equals_plain(*r) for r in recorded)

    a = core.initial_state(keys[:64])
    b = a.clone()
    for i, act in enumerate(ki.draw_actions(gen, 100, 64)):
        a, out_a = core.step_batched(a, act)
        b, out_b = core.step(b, act)
        assert torch.isfinite(out_a.reward).all(), i
        for x, y in [(out_a.reward, out_b.reward), (out_a.terminated, out_b.terminated),
                     (out_a.info["hit"], out_b.info["hit"]), (a.key, b.key),
                     (core.materialize_grid(a), b.grid),
                     *((a.context[k], b.context[k])
                       for k in ("tree_count", "fire_count", "position", "time"))]:
            assert torch.equal(x, y), i


@pytest.mark.gpu
def test_wrapper_rejects_inputs_off_the_grids_device(cuda):
    g, w, p, e, c = as_torch(make_inputs(7, 2, 8, 32, np.int8, 2, ("ca", "idle")), cuda)
    with pytest.raises(ValueError):
        wk.windy_fused_step(g, w.cpu(), p, e, c, empty=EMPTY, tree=TREE, fire=FIRE)


@pytest.mark.gpu
def test_entry_points_default_to_the_card(cuda):
    """From this checkout (its kernels build into the package directory)."""
    import gymca_torch

    assert Path(gymca_torch.__file__).resolve().parents[1] == Path(__file__).resolve().parents[1]
    core = BulldozerCore(32, 128)
    assert core.device.type == "cuda"
    states = core.initial_state(torch.as_tensor(key_data(21, 2)))
    assert states.grid.device.type == "cuda"


# --- K2/K3: the fused Alexandridis kernel ---------------------------------------------


def alexandridis_case(seed, n, h, w, device):
    """Kernel inputs and keywords at one lattice size, from numpy: fires,
    dousing, terrain factors away from 1, ages at and around 1."""
    r = np.random.default_rng(seed)
    cells = r.random((n, h, w))
    grid = np.where(cells < 0.1, 2, np.where(cells < 0.85, 1, 0)).astype(np.int8)
    ca = AlexandridisCA(h)
    x = dict(
        grid=torch.tensor(grid),
        fire_age=torch.tensor(r.choice(np.float32([0.5, 1.0, 1.5, 2.0, 60.0]), (n, h, w))),
        dousing=torch.tensor((r.random((n, h, w)) < 0.05).astype(np.int8)),
        vdf=torch.tensor(r.uniform(0.5, 3.0, (n, h, w)).astype(np.float32)).to(torch.bfloat16),
        exp_slope=torch.tensor(r.uniform(0.8, 1.25, (n, 3, 3, h, w)).astype(np.float32)
                               ).to(torch.bfloat16),
        wind_rows=torch.tensor(r.uniform(0.5, 4.0, (n, 8)).astype(np.float32)),
        seeds=torch.tensor(r.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.int64)),
    )
    kw = dict(empty=0, tree=1, fire=2, layer_coeffs=telescoped_box_coeffs(ca.burn_layer_weights),
              dousing_border=ca._dousing_border, dousing_inner=ca._dousing_inner,
              fire_age_min=ca.fire_age_min, fire_age_max=ca.fire_age_max)
    return {k: v.to(device) for k, v in x.items()}, kw


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,w", [(64, 256, 256), (4, 512, 512), (2, 1024, 1024),
                                   (16, 40, 50), (3, 24, 136)])
def test_alexandridis_kernel_matches_plain_on_the_card(cuda, n, h, w):
    x, kw = alexandridis_case(30, n, h, w, cuda)
    before = ak.alexandridis_fused_step.launches
    g, a = ak.alexandridis_fused_step(**x, **kw)
    torch.cuda.synchronize()
    assert ak.alexandridis_fused_step.launches == before + 1
    pg, pa = ak.alexandridis_fused_step_plain(**x, **kw)
    assert torch.equal(g, pg) and torch.equal(a, pa)
    assert int(((g == 2) & (x["grid"] == 1)).sum()) > 0  # some trees ignited


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ki.K2_LAYOUTS)
@pytest.mark.parametrize("n,h,w,radius", [(16, 256, 256, None), (4, 96, 200, None),
                                          (16, 256, 256, 2), (4, 512, 512, None),
                                          (2, 100, 136, 32)])
@pytest.mark.parametrize("ablate", ["", "prng"])
def test_alexandridis_kernel_on_tile_layouts_matches_plain(cuda, layout, n, h, w, radius,
                                                           ablate):
    """The layouts that can break the tiling (fire on tile edges only, burning
    tiles beside fire-free ones, fire only in a tile's 1-cell halo, all fire
    and none), at radius 2 (halo 2), 6, 7 and 32, ragged and whole tiles."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(40)
    x, kw = ki.alexandridis_inputs(n, h, w, gen, device=cuda, layout=layout, radius=radius)
    g, a = ak.alexandridis_fused_step(**x, **kw, ablate=ablate)
    pg, pa = ak.alexandridis_fused_step_plain(**x, **kw, ablate=ablate)
    assert torch.equal(g, pg) and torch.equal(a, pa)


@pytest.mark.gpu
def test_alexandridis_kernel_on_the_card_matches_the_cpu(cuda):
    """The kernel's draws and float operations equal the plain version's on
    the CPU too."""
    x, kw = alexandridis_case(31, 4, 64, 96, "cpu")
    g, a = ak.alexandridis_fused_step(**{k: v.to(cuda) for k, v in x.items()}, **kw)
    pg, pa = ak.alexandridis_fused_step(**x, **kw)
    assert torch.equal(g.cpu(), pg) and torch.equal(a.cpu(), pa)


@pytest.mark.gpu
def test_advanced_env_on_the_card_matches_the_cpu(cuda):
    """The fused env on the card against the same env on the CPU with the
    kernel's plain version, from one terrain, over 20 steps, leaf by leaf
    (observation, context, reward and info); at step 10 env 0 loses its
    fire and resets on both."""
    n = 4
    cpu = AdvancedForestFireBulldozerEnv(64, 64, key=rng.key(3, device="cpu"), num_envs=n,
                                         use_fused_ca=True, device="cpu")
    gpu = AdvancedForestFireBulldozerEnv(64, 64, key=rng.key(3, device="cpu"), num_envs=n,
                                         terrain=cpu._terrain_ctx)
    assert gpu.use_fused_ca and gpu.device.type == "cuda"
    (c_rgb, c_ctx), c_info = cpu.reset()
    (g_rgb, g_ctx), g_info = gpu.reset()
    r = np.random.default_rng(32)
    for i in range(20):
        a = torch.tensor(np.stack([r.integers(0, 9, n), r.integers(0, 2, n),
                                   np.zeros(n, int)], -1).astype(np.int32))
        if i == 10:
            for tg in (c_ctx["per_env_context"]["true_grid"],
                       g_ctx["per_env_context"]["true_grid"]):
                tg[0] = torch.where(tg[0] == 2, 1, tg[0])
        before = ak.alexandridis_fused_step.launches
        cs = cpu.conditional_reset(cpu.stateless_step(a, (c_rgb, c_ctx), c_info), a)
        gs = gpu.conditional_reset(gpu.stateless_step(a.to(cuda), (g_rgb, g_ctx), g_info),
                                   a.to(cuda))
        assert ak.alexandridis_fused_step.launches == before + 1
        (c_rgb, c_ctx), c_info = cs[0], cs[4]
        (g_rgb, g_ctx), g_info = gs[0], gs[4]
        assert torch.equal(g_rgb.cpu(), c_rgb), i
        assert torch.equal(gs[1].cpu(), cs[1]), i
        for k, v in c_ctx["per_env_context"].items():
            assert torch.equal(g_ctx["per_env_context"][k].cpu(), v), (i, k)
        for k in ("position", "time"):
            assert torch.equal(g_ctx[k].cpu(), c_ctx[k]), (i, k)
        for k, v in c_info.items():
            assert torch.equal(g_info[k].cpu(), v), (i, k)
        assert i != 10 or float(c_info["steps_elapsed"][0]) == 0.0  # env 0 was reset


@pytest.mark.gpu
def test_advanced_env_defaults_to_the_card(cuda):
    env = AdvancedForestFireBulldozerEnv(16, 128, key=rng.key(0), num_envs=2)
    assert env.device.type == "cuda" and env.use_fused_ca
    (rgb, _), _ = env.reset()
    assert rgb.device.type == "cuda"


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bit patterns, so that a comparison tells -0 from 0."""
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


@own_process("host")
@pytest.mark.gpu
@pytest.mark.parametrize("h,w,n", [(17, 23, 3), (256, 256, 2), (256, 256, 64)])
def test_terrain_drawn_on_the_card_equals_the_cpus(cuda, h, w, n):
    """The env built on the card from a card key draws its terrain there,
    with nothing injected; every leaf equals the CPU's draw from the same
    seed, bit for bit."""
    gpu = AdvancedForestFireBulldozerEnv(h, w, key=rng.key(4), num_envs=n)
    cpu = AdvancedForestFireBulldozerEnv(h, w, key=rng.key(4, device="cpu"), num_envs=n,
                                         device="cpu")
    assert gpu.starting_key.device.type == "cuda"
    assert set(gpu._terrain_ctx) == set(TERRAIN_KEYS)
    differing = {k: int((bits(v.cpu()) != bits(cpu._terrain_ctx[k])).sum())
                 for k, v in gpu._terrain_ctx.items()}
    assert differing == dict.fromkeys(TERRAIN_KEYS, 0)
    assert all(v.device.type == "cuda" for v in gpu._terrain_ctx.values())


@pytest.mark.gpu
def test_the_default_alexandridis_instance_keeps_its_registers(cuda):
    """The step's vector form in ptxas's report of this build: 64 registers
    (the cap its launch bounds set), one barrier, no spill."""
    from gymca_torch import _build

    built = _build.build(["alexandridis"])["alexandridis"]
    found = [lines for name, lines in built.ptxas_entries().items()
             if "alexandridis_kernelILi0ELb1E" in name]
    assert len(found) == 1, found
    assert any("Used 64 registers, used 1 barriers" in ln for ln in found[0]), found
    assert any("0 bytes spill stores, 0 bytes spill loads" in ln for ln in found[0]), found


@pytest.mark.gpu
def test_advanced_main_path_on_the_card(cuda):
    """The Advanced cell's path, 64 x 256² x 100 steps, and the tiled branch,
    8 x 512² x 20, with no host sync: K2 once a step, ten threefry launches
    a step, finite rewards, uint8 RGB; K2 equal to its plain version where
    the steps ended."""
    counters = (wk.windy_fused_step, ak.alexandridis_fused_step, rng.threefry_launch)
    for n, size, steps in ((64, 256, 100), (8, 512, 20)):
        env = AdvancedForestFireBulldozerEnv(size, size, key=rng.key(0), num_envs=n)
        assert env.use_fused_ca
        obs, info = env.reset()
        gen = torch.Generator(device=cuda)
        gen.manual_seed(size)
        actions = ki.adv_actions(gen, steps, n)
        before = [c.launches for c in counters]
        with no_host_sync():
            obs, info, last = ki.adv_run(env, obs, info, actions)
        assert [c.launches - b for c, b in zip(counters, before)] == [0, steps, 10 * steps]
        assert last[1].shape == (n,) and torch.isfinite(last[1]).all()
        assert obs[0].shape == (n, size, size, 3) and obs[0].dtype == torch.uint8
        recorded = ki.record_alexandridis_launches(env, obs, info, ki.adv_actions(gen, 3, n))
        assert len(recorded) == 3 and all(alexandridis_equals_plain(*r) for r in recorded)


def fire_stats(env, steps, checkpoints):
    """Per env, from a reset with the agents standing still (as
    ``scripts/validate_fused_ca_tpu.py`` runs): fire cells, burned cells
    (trees at the reset that are trees no more) and the burning cells' mean
    age at each checkpoint, as float64 on the host."""
    obs, info = env.reset()
    stay = torch.tensor([[4, 0, 0]] * env.num_envs, dtype=torch.int32, device=env.device)
    trees0 = (obs[1]["per_env_context"]["true_grid"] == 1).sum(dim=(1, 2))
    out = {}
    for t in range(1, steps + 1):
        obs, info, _ = ki.adv_run(env, obs, info, [stay])
        if t in checkpoints:
            pe = obs[1]["per_env_context"]
            fire = pe["true_grid"] == 2
            fires = fire.sum(dim=(1, 2))
            age = torch.where(fire, pe["fire_age"], 0.0).sum(dim=(1, 2)) / fires.clamp(min=1)
            burned = trees0 - (pe["true_grid"] == 1).sum(dim=(1, 2))
            out[t] = [v.double().cpu() for v in (fires, burned, age)]
    return out


@pytest.mark.gpu
def test_fused_ca_statistics_match_the_xla_path_on_the_card(cuda):
    """The fused kernel draws otherwise than the XLA-path counterpart, so the
    two are held by their statistics (``ROADMAP.md`` §E item 1): 64 envs at
    256², one terrain, agents standing still; at t = 100, 200, 300 the mean
    fire cells, burned cells and fire age within 4 sqrt(σ_f²/n + σ_x²/n)."""
    n, checkpoints = 64, (100, 200, 300)
    fused = AdvancedForestFireBulldozerEnv(256, 256, key=rng.key(0), num_envs=n)
    xla = AdvancedForestFireBulldozerEnv(256, 256, key=rng.key(0), num_envs=n,
                                         use_fused_ca=False, terrain=fused._terrain_ctx)
    assert fused.use_fused_ca and not xla.use_fused_ca
    stats = [fire_stats(env, checkpoints[-1], checkpoints) for env in (fused, xla)]
    for t in checkpoints:
        for what, f, x in zip(("fire cells", "burned cells", "mean fire age"), *(
                s[t] for s in stats)):
            band = 4.0 * math.hypot(f.std(unbiased=False).item(),
                                    x.std(unbiased=False).item()) / math.sqrt(n)
            assert abs(f.mean().item() - x.mean().item()) <= band, (t, what)


# --- the probes -----------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["banded", "bool", "fma", "swar"])
@pytest.mark.parametrize("n,h,w,offset", [
    (4, 64, 128, 0), (3, 40, 52, 0), (2, 256, 256, 0), (2, 24, 50, 0),
    (256, 256, 256, 0), (64, 250, 256, 0), (2, 3, 64, 0), (1, 512, 512, 0), (1, 1, 64, 0),
    (3, 64, 128, 4),  # a view 4 bytes into a larger buffer: word loads, no bulk copy
    # word loads over more envs than there are resident clusters: rounds of
    # both stages and their count slots
    (600, 40, 52, 4), (600, 64, 128, 4),
])
def test_ca_variant_kernel_matches_plain_on_the_card(cuda, variant, n, h, w, offset):
    from gymca_torch.probes import ca_variants_kernel as cv
    from gymca_torch.probes.exp_ca_variants import make_inputs

    grid, weights = make_inputs(n, h, w, n + h, cuda)
    if offset:
        buf = torch.zeros(grid.numel() + 16, dtype=torch.int8, device=cuda)
        grid = buf[offset:offset + grid.numel()].view(n, h, w)
        grid.copy_(make_inputs(n, h, w, n + h, cuda)[0])
        assert grid.data_ptr() % 16 == offset
    if variant == "swar" and w % 4:
        with pytest.raises(ValueError):
            cv.ca_variant_step(variant, grid, weights)
        return
    a, b = (grid if offset else grid.clone()), grid.clone()
    before = cv.ca_variant_step.launches[variant]
    for _ in range(5):
        a, ca = cv.ca_variant_step(variant, a, weights)
        b, cb = cv.PLAIN[variant](b, weights)
        assert torch.equal(a, b) and torch.equal(ca, cb)
    assert cv.ca_variant_step.launches[variant] == before + 5


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,w,steps", [(256, 256, 256, 40), (4096, 256, 256, 3),
                                         (2, 512, 512, 5), (8, 64, 128, 10), (4, 40, 52, 10),
                                         (4, 40, 50, 10)])
def test_ca_variant_kernel_matches_plain_at_the_probes_sizes(cuda, n, h, w, steps):
    """The script's 256 envs of 256² over its 40 steps, K1's all-CA 4096 envs
    (the bulk copies of many rounds of clusters) and four smaller grids: the
    four formulations from one draw, each equal to its plain version at
    every step, end on the same grids and counts; the swar wrapper raises
    where W is not a multiple of 4."""
    from gymca_torch.probes import ca_variants_kernel as cv
    from gymca_torch.probes.exp_ca_variants import make_inputs

    grid, weights = make_inputs(n, h, w, 0, cuda)
    finals = []
    for v in cv.VARIANTS:
        if v == "swar" and w % 4:
            with pytest.raises(ValueError):
                cv.ca_variant_step(v, grid.clone(), weights)
            continue
        a, b = grid.clone(), grid.clone()
        for _ in range(steps):
            a, ca = cv.ca_variant_step(v, a, weights)
            b, cb = cv.PLAIN[v](b, weights)
            assert torch.equal(a, b) and torch.equal(ca, cb), v
        finals.append((a, ca))
    assert all(torch.equal(g, finals[0][0]) and torch.equal(c, finals[0][1]) for g, c in finals)


@pytest.mark.gpu
def test_each_ca_variant_has_a_bulk_store_loop_in_its_sass(cuda):
    """``cuobjdump -sass`` of this build: each formulation's bulk form has
    an innermost loop around its 16-byte stores (the loop its instruction
    bound is read from, ``gymca_torch.probes.sass``)."""
    from gymca_torch import _build
    from gymca_torch.probes import sass
    from gymca_torch.probes.ca_variants_kernel import VARIANTS

    fns = sass.functions(sass.cuobjdump_sass(_build.build(["ca_variants"])["ca_variants"].path))
    for v in VARIANTS:
        found = [f for name, f in fns.items() if f"ca_{v}_kernelILb1E" in name]
        assert len(found) == 1 and sass.inner_loop(found[0], "STG.E.128") is not None, v


@pytest.mark.gpu
def test_ca_variant_kernel_refuses_grids_past_its_shared_memory(cuda):
    from gymca_torch.probes import ca_variants_kernel as cv
    from gymca_torch.probes.exp_ca_variants import make_inputs

    grid, weights = make_inputs(1, 1024, 1024, 0, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        cv.ca_variant_step("bool", grid, weights)


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,w", [(3, 16, 32), (64, 256, 256), (8, 512, 512), (2, 40, 52)])
def test_dma_floor_kernel_matches_plain_on_the_card(cuda, n, h, w):
    from gymca_torch.probes.dma_floor_kernel import dma_floor, dma_floor_plain

    x, _ = alexandridis_case(40, n, h, w, cuda)
    args = [x[k] for k in ("grid", "fire_age", "dousing", "vdf", "exp_slope", "wind_rows",
                           "seeds")]
    before = dma_floor.launches
    got, want = dma_floor(*args), dma_floor_plain(*args)
    assert dma_floor.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("table_w", [0, 1, 8, 16])
@pytest.mark.parametrize("counts_w,staged", [(0, False), (1, False), (4, False), (1, True),
                                             (4, True)])
@pytest.mark.parametrize("n,envs_per_block", [(4096, 128), (4096, 4096), (100, 12), (4096, 1),
                                              (4096, 31), (4096, 1000), (1000, 4096),
                                              (4096, 512)])
def test_probe_floor_kernel_matches_plain_on_the_card(cuda, table_w, counts_w, staged, n,
                                                      envs_per_block):
    from gymca_torch.probes.floor_kernel import probe_floor, probe_floor_plain

    if staged and (envs_per_block * counts_w % 4 or n * counts_w % 4):
        pytest.skip("the staged form needs 16-byte units")  # the wrapper raises; tested on the CPU
    gen = torch.Generator(device=cuda)
    gen.manual_seed(table_w * 10 + counts_w)
    table = (torch.randint(-2**31, 2**31 - 1, (n, table_w), generator=gen, device=cuda,
                           dtype=torch.int32) if table_w else None)
    grid = torch.zeros((n, 8, 16), dtype=torch.int8, device=cuda)
    got = probe_floor(grid, table, counts_w=counts_w, envs_per_block=envs_per_block,
                      staged=staged)
    want = probe_floor_plain(n, table, counts_w=counts_w, device=cuda)
    assert (got is None and want is None) or torch.equal(got, want)
    assert not grid.any()


@pytest.mark.gpu
@pytest.mark.parametrize("size", [16, 16 * 1024, 16 * 1024 + 48, 8 * 16 * 1024,
                                  196608 // 2, 1536 * 1024, 1536 * 1024 + 16])
def test_one_sm_copy_kernel_copies_on_the_card(cuda, size):
    """One chunk, one partial chunk past it, every stage once, half of S3's
    bytes, and many rounds of the stages, whole and with a partial last
    chunk."""
    from gymca_torch.probes.floor_kernel import one_sm_copy

    gen = torch.Generator(device=cuda)
    gen.manual_seed(size)
    src = torch.randint(-128, 128, (size,), generator=gen, device=cuda, dtype=torch.int8)
    dst = torch.zeros_like(src)
    assert torch.equal(one_sm_copy(src, dst), src)


@pytest.mark.gpu
@pytest.mark.parametrize("ablate", ["boxes", "ignite", "prng"])
@pytest.mark.parametrize("n,h,w", [(64, 256, 256), (8, 512, 512), (3, 40, 50)])
def test_alexandridis_ablation_matches_plain_on_the_card(cuda, ablate, n, h, w):
    x, kw = alexandridis_case(41, n, h, w, cuda)
    g, a = ak.alexandridis_fused_step(**x, **kw, ablate=ablate)
    pg, pa = ak.alexandridis_fused_step_plain(**x, **kw, ablate=ablate)
    assert torch.equal(g, pg) and torch.equal(a, pa)


@pytest.mark.gpu
def test_probe_entry_points_run_on_the_card(cuda):
    """Every probe kernel launches on the probes' entry points; at every
    launch configuration the floor family's entry points time, on their
    tables, ``probe_floor`` equals its plain version, and where the counts
    are ``[p[e, 4], p[e, 5], 0, 0]`` so does one ``F.pad`` of the table (their
    library yardstick)."""
    import torch.nn.functional as F

    from gymca_torch.probes import (
        bench_fused_ca,
        exp_ca_variants,
        exp_counts_out,
        exp_floor,
        exp_kernel_overhead,
        exp_launch_floor,
        floor_kernel,
    )
    from gymca_torch.probes.ca_variants_kernel import ca_variant_step
    from gymca_torch.probes.dma_floor_kernel import dma_floor
    from gymca_torch.probes.floor_kernel import FloorVariant, probe_floor, probe_floor_plain

    def launches():
        return [*ca_variant_step.launches.values(), dma_floor.launches, probe_floor.launches,
                ak.alexandridis_fused_step.launches]

    before = launches()
    rows = exp_ca_variants.run(cuda, n=4, h=64, w=64, steps=3, reps=1)
    assert all(r["equal"] and r["device_us"] > 0 for r in rows)
    out = bench_fused_ca.run(cuda, size=64, envs=2, steps=3, reps=1)
    assert all(out[f"{m}_us"] > 0 for m in bench_fused_ca.MODES)
    rows = floor_kernel.run_variants([FloorVariant("f", 256, 32, 16, 4, staged=True)], 3,
                                     cuda, reps=1, h=4, w=4)
    assert rows[0]["device_us"] > 0
    assert all(a > b for a, b in zip(launches(), before))
    for mod in (exp_counts_out, exp_launch_floor, exp_kernel_overhead, exp_floor):
        grid = torch.zeros((4096, 256, 256), dtype=torch.int8, device=cuda)
        for v, table in zip(mod.VARIANTS, floor_kernel.variant_tables(mod.VARIANTS, cuda)):
            got = probe_floor(grid[:v.n] if v.grid else None, table, counts_w=v.counts_w,
                              envs_per_block=v.envs_per_block, staged=v.staged)
            want = probe_floor_plain(v.n, table, counts_w=v.counts_w, device=cuda)
            assert (got is None and want is None) or torch.equal(got, want), v
            if v.table_w >= 6 and v.counts_w:
                assert torch.equal(F.pad(table[:, 4:6], (0, v.counts_w - 2)), want), v


# --- the PPO trainer ------------------------------------------------------------------------


def trainer_args(n, size, steps, **exp_kw):
    from gymca_torch.agents.args import Args, EnvArgs, ExperimentArgs, PPOArgs

    return Args(ppo=PPOArgs(num_minibatches=2, update_epochs=2),
                env=EnvArgs(num_envs=n, size=size),
                exp=ExperimentArgs(total_timesteps=n * steps * 4, num_ppo_steps=steps, seed=3,
                                   **exp_kw))


@pytest.mark.gpu
def test_train_iteration_on_the_card(cuda):
    """One ``train_iteration`` at 4 envs x 64², 8 steps, on the fused env:
    one Alexandridis launch per env step (``k2_each_env_step``), the
    rollout with no host sync, finite metrics, the params moved."""
    from gymca_torch.agents.ppo import EpisodeStatistics, PPOTrainer

    n, steps = 4, 8
    env = AdvancedForestFireBulldozerEnv(64, 64, key=rng.key(0), num_envs=n)
    trainer = PPOTrainer(env, trainer_args(n, 64, steps))
    assert env.use_fused_ca and trainer.device.type == "cuda"
    obs, info = env.reset()
    carry = (trainer.agent_state, EpisodeStatistics.create(n), obs,
             torch.zeros(n, dtype=torch.bool, device=cuda), info, trainer.key)
    with k2_each_env_step(steps):
        trainer.rollout(*carry)  # warm: cuDNN, the kernel build, the graphs' captures
    torch.cuda.synchronize()
    with k2_each_env_step(steps):
        torch.cuda.set_sync_debug_mode("error")
        try:
            trainer.rollout(*carry)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    with k2_each_env_step(steps):
        out = trainer.train_iteration(*carry)
    assert all(torch.isfinite(v).all() for v in out[-1].values())
    moved = [not torch.equal(a, b) for g in out[0].params
             for a, b in zip(out[0].params[g].values(), carry[0].params[g].values())]
    assert any(moved)


@pytest.mark.gpu
@pytest.mark.parametrize("size", [64, 256])
def test_networks_on_the_card_match_the_cpu(cuda, size):
    """The same weights on the card and on the CPU, float32 with TF32 off:
    hidden, logits and value within rtol 1e-4, atol 1e-5."""
    from gymca_torch.agents.networks import Actor, Critic, Network

    gen = torch.Generator().manual_seed(size)
    mods = [Network(size, size, generator=gen), Actor(128, (9, 2), ((2, 1),), generator=gen),
            Critic(128, generator=gen)]
    grid = torch.from_numpy(np.random.default_rng(size).integers(0, 256, (2, size, size, 3),
                                                                  dtype=np.uint8))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            outs = []
            for dev in ("cpu", cuda):
                net, actor, critic = (m.to(dev) for m in mods)
                hidden = net(grid.to(dev))
                outs.append([hidden] + actor(hidden) + [critic(hidden)])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for c, g in zip(*outs):
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    from gymca_torch.agents.checkpoint import CheckpointManager
    from gymca_torch.agents.ppo import PPOTrainer

    env = AdvancedForestFireBulldozerEnv(16, 128, key=rng.key(0), num_envs=2)
    trainer = PPOTrainer(env, trainer_args(2, 16, 4))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save_state(2, trainer.agent_state, trainer.key, env_carry={"obs": env.reset()[0][0]})
    fresh = PPOTrainer(env, trainer_args(2, 16, 4), key=rng.key(99))
    state, key, carry = mgr.restore_state(fresh.agent_state, fresh.key,
                                          env_carry={"obs": None})
    assert key.device.type == "cuda" and torch.equal(key, trainer.key)
    assert carry["obs"].device.type == "cuda"
    for g, leaves in trainer.agent_state.params.items():
        for k, v in leaves.items():
            assert state.params[g][k].device.type == "cuda"
            assert torch.equal(state.params[g][k], v)


@pytest.mark.gpu
def test_train_at_the_default_cell_on_the_card(cuda):
    """``train()`` at ``scripts/run``'s defaults, one iteration: K2 checked,
    finite metrics, the params moved; a rollout and an update with no host
    sync: K2 once a step, finite losses; the trained networks on the card
    and the CPU, TF32 off, within rtol 1e-4, atol 1e-5."""
    trainer, carry = default_cell_trainer(cuda)
    steps = trainer.args.exp.num_ppo_steps
    start = trainer.agent_state.params
    with k2_each_env_step(steps, check=True):
        state, history = trainer.train(num_iterations=1)
    assert finite_metrics(history) and not params_equal(start, state.params)

    with k2_each_env_step(steps), no_host_sync():
        after, storage = trainer.rollout(state, *carry[1:])
    with no_host_sync():
        losses = trainer.learn(after[0], after[2], after[3], storage, after[5])[1]
    assert all(torch.isfinite(v) for v in losses.values())

    def heads(params, grid):
        hidden = trainer._torso(params, grid, None)
        return [hidden] + trainer._actor_logits(params, hidden) + [trainer._value(params, hidden)]

    grid = carry[2][0]
    cpu_params = {g: {k: v.cpu() for k, v in d.items()} for g, d in state.params.items()}
    flags = torch.backends.cudnn
    tf32, flags.allow_tf32 = flags.allow_tf32, False
    try:
        with torch.no_grad():
            got, want = heads(state.params, grid), heads(cpu_params, grid.cpu())
    finally:
        flags.allow_tf32 = tf32
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_critic_warmup_iteration_freezes_torso_and_actor_on_the_card(cuda):
    """Round 5's pipeline flags (``scripts/sweep_r5_kickstart256.sh``), 1 BC
    and 1 critic-warmup iteration, cut to 8 envs x 16 steps x 3 iterations:
    K2 once a step, finite metrics; the critic-only iteration leaves torso
    and actor bit-identical and moves the critic; kickstart moves the actor."""
    from gymca_torch.agents.ppo import PPOTrainer
    from gymca_torch.run import args_to_structured_args, build_env, parse_args

    args = args_to_structured_args(parse_args(
        ["-n", "8", "-z", "256", "--num-ppo-steps", "16", "--bf16", "--centroid-features",
         "--shape-tree-coef", "20", "--shape-dist-coef", "2", "--shape-douse-coef", "20",
         "--bc-iters", "1", "--critic-warmup-iters", "1", "--kickstart-coef", "1.0"]))
    args.exp.checkpoint_every = 1
    env = build_env(args)
    assert env.use_fused_ca
    trainer = PPOTrainer(env, args, key=rng.key(args.exp.seed))

    class Saved(dict):
        """Stands in for a checkpoint manager: each iteration's state."""

        def save_state(self, step, agent_state, key):
            self[step] = agent_state

    saved, iters = Saved(), 3
    with k2_each_env_step(iters * 16, eager=16):  # the BC iteration's 16 steps: eager
        bc = trainer.bc_pretrain(args.exp.bc_iters)
        cloned = trainer.agent_state.params
        history = trainer.train(num_iterations=iters, checkpoint_manager=saved)[1]
    assert finite_metrics([bc] + history)
    warm = saved[1].params
    assert params_equal(cloned, warm, ("network_params", "actor_params"))
    assert not params_equal(cloned, warm, ("critic_params",))
    assert not params_equal(warm, saved[iters].params, ("actor_params",))


# --- slice 7: the Helicopter and the evaluation -----------------------------------------


def helicopter_run(core, n, actions, seed=0):
    from gymca_torch.core.env import autoreset_step

    state = core.initial_state(rng.split(rng.key(seed, device=core.device), n))
    trail = []
    for a in actions:
        state, out = autoreset_step(core, state, a.to(core.device))
        trail.append((state, out))
    return trail


@pytest.mark.gpu
@pytest.mark.parametrize("size,n,steps", [((42, 42), 16, 70), ((17, 23), 5, 40),
                                          ((42, 42), 64, 70)])
def test_helicopter_on_the_card_matches_the_cpu(cuda, size, n, steps):
    """Every leaf of every step, bit for bit, over three CA applications
    (freeze cycles) and more."""
    from gymca_torch.envs.helicopter import HelicopterCore

    actions = torch.from_numpy(np.random.default_rng(1).integers(0, 9, (steps, n))
                               .astype(np.int32))
    card = helicopter_run(HelicopterCore(*size), n, actions)
    cpu = helicopter_run(HelicopterCore(*size, device="cpu"), n, actions)
    assert sum(int(s.context["freeze"][0] == 0) for s, _ in card) >= 3
    for t, ((sa, oa), (sb, ob)) in enumerate(zip(card, cpu)):
        assert sa.grid.device.type == "cuda"
        for x, y in [(sa.grid, sb.grid), (sa.key, sb.key), (oa.reward, ob.reward),
                     (sa.steps_elapsed, sb.steps_elapsed), (oa.info["hit"], ob.info["hit"]),
                     *((sa.context[k], sb.context[k]) for k in sa.context)]:
            assert torch.equal(x.cpu(), y), f"step {t}"


@pytest.mark.gpu
@pytest.mark.parametrize("size,n", [((42, 42), 4096), ((256, 256), 256)])
def test_helicopter_step_has_no_host_sync(cuda, size, n):
    """50 ``autoreset_step``s at the registered size and at 256²: cells in
    {0, 1, 2}, rewards finite in [-1, 1], never terminated."""
    from gymca_torch.core.env import autoreset_step
    from gymca_torch.envs.helicopter import HelicopterCore

    core = HelicopterCore(*size)
    state = core.initial_state(rng.split(rng.key(0), n))
    actions = torch.randint(0, 9, (50, n), device=cuda, dtype=torch.int32)
    with no_host_sync():
        for a in actions:
            state, out = autoreset_step(core, state, a)
    assert set(torch.unique(state.grid).tolist()) <= {core._empty, core._tree, core._fire}
    r = out.reward
    assert torch.isfinite(r).all() and ((r >= -1) & (r <= 1)).all()
    assert not out.terminated.any()


@pytest.mark.gpu
@pytest.mark.parametrize("actor", ["random", "scripted", "params"])
def test_eval_loop_on_the_card(cuda, actor, tmp_path):
    """``gymca_torch.run``'s evaluation loop at 4 envs x 64² on the fused
    env: one Alexandridis launch a step, no host sync, finite rewards; for
    the random and scripted actors the same rewards as the same loop on the
    CPU (the kernel's plain version there).  The params actor's greedy
    argmax may differ across devices where two logits nearly tie, so its
    rewards are not compared."""
    from gymca_torch import run
    from gymca_torch.agents.checkpoint import CheckpointManager
    from gymca_torch.agents.ppo import PPOTrainer

    argv = ["-n", "4", "-z", "64", "--no-train", "--steps", "16"]
    if actor == "params":
        args = run.args_to_structured_args(run.parse_args(argv))
        trainer = PPOTrainer(run.build_env(args, device="cpu"), args, device="cpu")
        CheckpointManager(str(tmp_path)).save_state(1, trainer.agent_state, trainer.key)
        argv += ["--params", str(tmp_path)]
    results = {}
    for device in ("cuda", "cpu"):
        args = run.args_to_structured_args(run.parse_args(argv))
        env = run.build_env(args, use_fused_ca=True, device=device)
        get_action = run.make_actor(args, env, actor)
        run.eval_loop(env, get_action, 1)  # warm: the kernel build and cuDNN
        get_action = run.make_actor(args, env, actor)
        if device == "cuda":
            torch.cuda.synchronize()
            before = ak.alexandridis_fused_step.launches
            torch.cuda.set_sync_debug_mode("error")
        try:
            results[device] = run.eval_loop(env, get_action, 16)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if device == "cuda":
            assert ak.alexandridis_fused_step.launches == before + 16
    assert torch.isfinite(results["cuda"].rewards).all()
    if actor != "params":
        np.testing.assert_array_equal(results["cuda"].rewards.cpu().numpy(),
                                      results["cpu"].rewards.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("actor", ["random", "scripted", "params"])
def test_eval_loop_at_the_default_cell_on_the_card(cuda, actor, tmp_path):
    """The evaluation at ``scripts/run``'s defaults, 50 steps with no host
    sync: K2 checked, rewards finite in [-1, 0]; the params actor restores a
    trainer's state through ``load_actor``."""
    from gymca_torch import run
    from gymca_torch.agents.checkpoint import CheckpointManager
    from gymca_torch.agents.ppo import PPOTrainer

    args = run.args_to_structured_args(run.parse_args(
        ["-n", "8", "-z", "256", "--no-train", "--steps", "50"]))
    env = run.build_env(args)
    assert env.use_fused_ca
    env.reset()  # copies its tables to the card once
    if actor == "params":
        trainer = PPOTrainer(env, args)
        CheckpointManager(str(tmp_path)).save_state(1, trainer.agent_state, trainer.key)
        args.exp.params_path = str(tmp_path)
    get_action = run.make_actor(args, env, actor)
    steps = args.viz.steps
    with k2_launched(steps, {0, steps - 1}), no_host_sync():
        r = run.eval_loop(env, get_action, steps).rewards
    assert r.shape == (steps, 8) and torch.isfinite(r).all() and ((r <= 0) & (r >= -1)).all()


@own_process("profiler")
@pytest.mark.gpu
@pytest.mark.parametrize("path", ["rollout", "update", "helicopter", "eval", "pinecones"])
def test_the_profiler_reads_device_time_on_the_card(cuda, path):
    """``probes.timing.profile_steps`` keeps device kernels of the paths no
    cell traces: the trainer's rollout (2 steps) and update, the Helicopter
    at 4096 x 42², the evaluation loop at its default cell and the pinecone
    env at 64 x 256² (3 steps or 1)."""
    from gymca_torch import run
    from gymca_torch.core.env import autoreset_step
    from gymca_torch.envs.helicopter import HelicopterCore
    from gymca_torch.probes.timing import card, profile_steps

    steps = 3
    if path == "rollout":
        trainer, carry = small_trainer(cuda)
        trainer.args.exp.num_ppo_steps = steps = 2

        def step():
            trainer.rollout(*carry)
    elif path == "update":
        trainer, carry = small_trainer(cuda)
        (state, _, obs, done, _, key), storage = trainer.rollout(*carry)
        steps = 1

        def step():
            trainer.learn(state, obs, done, storage, key)
    elif path == "helicopter":
        core = HelicopterCore(42, 42)
        start = core.initial_state(rng.split(rng.key(0), 4096))
        actions = torch.randint(0, 9, (steps, 4096), device=cuda, dtype=torch.int32)

        def step():
            state = start
            for a in actions:
                state, _ = autoreset_step(core, state, a)
    elif path == "eval":
        args = run.args_to_structured_args(run.parse_args(["-n", "8", "-z", "256"]))
        env = run.build_env(args)
        get_action = run.make_actor(args, env, "random")

        def step():
            run.eval_loop(env, get_action, steps)
    else:
        env = AdvancedForestFireBulldozerEnv(256, 256, key=rng.key(0), num_envs=64,
                                             enable_pinecones=True)
        obs, info = env.reset()
        actions, steps = ki.adv_actions(torch.Generator(device=cuda), 1, 64), 1

        def step():
            ki.adv_run(env, obs, info, actions)
    step()  # warm
    prof = profile_steps(step, steps, path, card())
    assert prof is not None and prof["busy_us_per_step"] > 0


# --- slice 8: pinecones and the policy evaluation ------------------------------------------


def burning_block(obs):
    """``obs`` with a block of trees in the middle of every env set burning,
    so that embers fly."""
    rgb, ctx = obs
    ctx, per_env = dict(ctx), dict(ctx["per_env_context"])
    tg = per_env["true_grid"].clone()
    h, w = tg.shape[-2:]
    sub = tg[:, h // 3:2 * h // 3, w // 3:2 * w // 3]
    tg[:, h // 3:2 * h // 3, w // 3:2 * w // 3] = torch.where(sub == 1, 2, sub)
    per_env["true_grid"] = tg
    ctx["per_env_context"] = per_env
    return rgb, ctx


def landing_order(rows, cols, lit, h, w):
    """Of one pinecone landing (every entry of every cell, lit or not): the
    lit entries, and the cells where a lit entry is followed by an unlit
    one, so that the order of the landings decides the cell."""
    at = rows.long() * w + cols
    order = torch.arange(at.shape[1], device=at.device).expand_as(at)
    none = torch.full((at.shape[0], h * w), -1, dtype=torch.int64, device=at.device)
    last = none.scatter_reduce(1, at, order, reduce="amax")
    last_lit = none.scatter_reduce(1, at, torch.where(lit, order, -1), reduce="amax")
    return torch.stack([lit.sum(), ((last_lit >= 0) & (last_lit < last)).sum()])


@own_process("host")
@pytest.mark.gpu
@pytest.mark.parametrize("size,n,steps", [((42, 42), 4, 20), ((17, 23), 3, 20),
                                          ((64, 64), 4, 30)])
def test_pinecone_env_on_the_card_matches_the_cpu(cuda, size, n, steps):
    """The Advanced env with pinecones (its XLA-path counterpart: the fused
    kernel has none) on the card against the CPU, from one terrain and a
    burning block, every leaf of every step bit for bit; embers are lit, and
    on some cell a lit entry lands before an unlit one (the landing order
    decides the cell)."""
    envs = {}
    for device in ("cpu", "cuda"):
        envs[device] = AdvancedForestFireBulldozerEnv(
            *size, key=rng.key(5, device="cpu"), num_envs=n, enable_pinecones=True,
            device=device, terrain=envs["cpu"]._terrain_ctx if envs else None)
    assert not envs["cuda"].use_fused_ca
    landed = []
    real_land = AlexandridisCA._land_pinecones

    def land(self, grid, fire_age, rows, cols, lit, ages):
        if grid.is_cuda:
            landed.append(landing_order(rows, cols, lit, *grid.shape[-2:]))
        return real_land(self, grid, fire_age, rows, cols, lit, ages)

    AlexandridisCA._land_pinecones = land
    try:
        state = {}
        for d, env in envs.items():
            obs, info = env.reset()
            state[d] = burning_block(obs) + (info,)
        r = np.random.default_rng(7)
        for i in range(steps):
            a = torch.tensor(np.stack([r.integers(0, 9, n), r.integers(0, 2, n),
                                       np.zeros(n, int)], -1).astype(np.int32))
            out = {}
            for d, env in envs.items():
                rgb, ctx, info = state[d]
                ad = a.to(d)
                out[d] = env.conditional_reset(env.stateless_step(ad, (rgb, ctx), info), ad)
                state[d] = out[d][0] + (out[d][4],)
            (c_rgb, c_ctx), (g_rgb, g_ctx) = out["cpu"][0], out["cuda"][0]
            assert torch.equal(g_rgb.cpu(), c_rgb), i
            assert torch.equal(out["cuda"][1].cpu(), out["cpu"][1]), i
            for k, v in c_ctx["per_env_context"].items():
                assert torch.equal(g_ctx["per_env_context"][k].cpu(), v), (i, k)
            for k in ("position", "time"):
                assert torch.equal(g_ctx[k].cpu(), c_ctx[k]), (i, k)
    finally:
        AlexandridisCA._land_pinecones = real_land
    lit, order_decided = torch.stack(landed).sum(0).tolist()
    assert len(landed) == steps and lit > 0 and order_decided > 0


@pytest.mark.gpu
def test_pinecone_env_at_the_cells_size_on_the_card(cuda):
    """The pinecone env at the Advanced cell's 64 x 256² takes the XLA-path
    counterpart: 10 steps with no host sync launch no K2 and give finite
    rewards."""
    env = AdvancedForestFireBulldozerEnv(256, 256, key=rng.key(0), num_envs=64,
                                         enable_pinecones=True)
    assert not env.use_fused_ca
    obs, info = env.reset()
    gen = torch.Generator(device=cuda)
    gen.manual_seed(8)
    actions = ki.adv_actions(gen, 10, 64)
    ki.adv_run(env, obs, info, actions[:1])  # warm: the compass table, the allocator
    before = ak.alexandridis_fused_step.launches
    with no_host_sync():
        last = ki.adv_run(env, obs, info, actions)[2]
    assert ak.alexandridis_fused_step.launches == before and torch.isfinite(last[1]).all()


@pytest.mark.gpu
def test_clamped_poisson_and_the_pinecone_step_have_no_host_sync(cuda):
    keys = rng.split(rng.key(1), 8)
    n_env = 4
    env = AdvancedForestFireBulldozerEnv(64, 64, key=rng.key(2), num_envs=n_env,
                                         enable_pinecones=True)
    obs, info = env.reset()
    obs = burning_block(obs)
    a = torch.tensor([[4, 1, 0]] * n_env, dtype=torch.int32, device=cuda)
    env.conditional_reset(env.stateless_step(a, obs, info), a)  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        counts = rng.poisson(keys, 1.0, (64, 64), max_count=5)
        for _ in range(5):
            obs, _, _, _, info = env.conditional_reset(env.stateless_step(a, obs, info), a)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert counts.dtype == torch.int32 and int(counts.max()) == 5
    assert torch.equal(counts.cpu(), rng.poisson(keys.cpu(), 1.0, (64, 64), max_count=5))


@pytest.mark.gpu
def test_eval_policy_loop_on_the_card(cuda):
    """``gymca_torch.eval_policy``'s episode loop at 4 envs x 64² on the
    fused env: one Alexandridis launch a step and no host sync for the
    trained policy and each probe; the probes' returns equal the same loop
    on the CPU with the kernel's plain version."""
    from gymca_torch import eval_policy
    from gymca_torch.agents.args import Args, EnvArgs, ExperimentArgs
    from gymca_torch.agents.ppo import PPOTrainer

    n, size, steps = 4, 64, 16
    card_env = AdvancedForestFireBulldozerEnv(size, size, key=rng.key(0), num_envs=n)
    cpu_env = AdvancedForestFireBulldozerEnv(size, size, key=rng.key(0, device="cpu"),
                                             num_envs=n, use_fused_ca=True, device="cpu")
    assert card_env.use_fused_ca
    args = Args(env=EnvArgs(num_envs=n, size=size),
                exp=ExperimentArgs(position_features=True, centroid_features=True))
    params = PPOTrainer(cpu_env, args, device="cpu").agent_state.params
    blob = {"params": {g: {k: t.to(cuda) for k, t in p.items()} for g, p in params.items()},
            "bf16": False, "position_features": True, "centroid_features": True}
    policies = [("trained-greedy", (lambda act: lambda obs, k: act(obs))(
        eval_policy.greedy_policy_fn(blob, card_env)))]
    policies += list(eval_policy.probe_policies(n, cuda))
    keys = rng.split(rng.key(17), steps)
    eval_policy.episode_returns(card_env, policies[0][1], keys[:1], n)  # warm: build, cuDNN
    cpu_probes = dict(eval_policy.probe_policies(n, "cpu"))
    for name, fn in policies:
        torch.cuda.synchronize()
        before = ak.alexandridis_fused_step.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            ret, done = eval_policy.episode_returns(card_env, fn, keys, n)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert ak.alexandridis_fused_step.launches == before + steps, name
        assert torch.isfinite(ret).all() and ret.device.type == "cuda"
        if name in cpu_probes:
            c_ret, c_done = eval_policy.episode_returns(cpu_env, cpu_probes[name], keys.cpu(),
                                                        n)
            assert torch.equal(ret.cpu(), c_ret) and torch.equal(done.cpu(), c_done), name


@own_process("host")
@pytest.mark.gpu
def test_train_curve_and_eval_policy_on_the_card(cuda, tmp_path):
    """``train_curve`` at 32 envs x 256², one iteration, ``--pallas-ca
    --bf16``: K2 checked, finite metrics, blob and JSON written, the card
    named; round 5's recipe (``modf``) cut: no K2, and with ``--pallas-ca`` a
    fallback warning.  ``eval_policy --probes`` on the blob, 16 envs x 25
    steps: every policy, K2 checked, finite returns; the modf blob: no K2."""
    import warnings

    from gymca_torch import eval_policy, train_curve

    blob, recipe_blob = tmp_path / "curve.pkl", tmp_path / "recipe.pkl"
    with k2_each_env_step(128, check=True):
        result = train_curve.main(["--size", "256", "--num-envs", "32", "--iters", "1",
                                   "--pallas-ca", "--bf16", "--tag", "card", "--out",
                                   str(tmp_path), "--save-params", str(blob)])
    assert finite_metrics(result["history"])
    assert result["hardware"].startswith(torch.cuda.get_device_name(0))
    assert blob.exists() and (tmp_path / "ppo_curve_card.json").exists()
    for extra in ([], ["--pallas-ca"]):
        before = ak.alexandridis_fused_step.launches
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            r = train_curve.main(
                ["--size", "256", "--num-envs", "8", "--iters", "2", "--bf16",
                 "--ca-repeat-mode", "modf", "--gamma", "0.999", "--shape-tree-coef", "20",
                 "--shape-dist-coef", "2", "--shape-douse-coef", "20", "--centroid-features",
                 "--bc-iters", "1", "--critic-warmup-iters", "1", "--kickstart-coef", "1.0",
                 "--kickstart-decay", "2", "--sm-schedule", "2:0.5,1:0.5", "--tag", "recipe",
                 "--out", str(tmp_path), "--save-params", str(recipe_blob)] + extra)
        assert ak.alexandridis_fused_step.launches == before and finite_metrics(r["history"])
        fell_back = any("falling back to the XLA CA path" in str(w.message) for w in caught)
        assert fell_back == bool(extra)

    with k2_launched(4 * 25, {p * 25 + i for p in range(4) for i in (0, 24)}):
        results = eval_policy.main(["--params", str(blob), "--envs", "16", "--steps", "25",
                                    "--probes"])
    assert [r["policy"] for r in results] == ["trained-greedy", "idle", "random", "greedy-fire"]
    before = ak.alexandridis_fused_step.launches
    modf = eval_policy.main(["--params", str(recipe_blob), "--envs", "16", "--steps", "10"])
    assert len(modf) == 1 and ak.alexandridis_fused_step.launches == before
    assert all(math.isfinite(r[k]) for r in results + modf for k in ("mean_return", "min", "max"))


# --- slice 9: parallel/ on a world of one rank ------------------------------------------


@pytest.fixture
def nccl(cuda):
    """A world of one rank on NCCL for the test, destroyed after it."""
    import socket

    import torch.distributed as dist

    from gymca_torch.parallel.mesh import initialize_distributed

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize_distributed(f"localhost:{port}", 1, 0)
    assert dist.get_backend() == "nccl"
    yield
    dist.destroy_process_group()


@pytest.mark.gpu
def test_data_parallel_ppo_iteration_on_nccl(cuda, nccl):
    """``DataParallelPPO`` on one rank, 4 envs x 64², 8 steps, 2 epochs of 2
    minibatches: an iteration launches K2 once an env step, all-reduces once
    a minibatch over NCCL, and makes no host sync."""
    from gymca_torch.agents.args import Args, EnvArgs, ExperimentArgs, PPOArgs
    from gymca_torch.parallel.mesh import make_mesh
    from gymca_torch.parallel.sharded import DataParallelPPO

    n, size, steps = 4, 64, 8
    env = AdvancedForestFireBulldozerEnv(size, size, key=rng.key(0), num_envs=n)
    assert env.use_fused_ca
    args = Args(ppo=PPOArgs(num_minibatches=2, update_epochs=2),
                env=EnvArgs(num_envs=n, size=size),
                exp=ExperimentArgs(num_ppo_steps=steps, total_timesteps=n * steps * 4))
    dp = DataParallelPPO(env, args, make_mesh(1), key=rng.key(5))
    carry = dp.init_carry()
    with k2_each_env_step(steps):
        dp.train_iteration(*carry)  # warm: cuDNN, NCCL's communicator, the graphs' captures
    torch.cuda.synchronize()
    reduces = dp.trainer.grad_all_reduces
    with k2_each_env_step(steps):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = dp.train_iteration(*carry)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert dp.trainer.grad_all_reduces == reduces + 4
    assert all(bool(torch.isfinite(v)) for v in out[-1].values())


@pytest.mark.gpu
def test_bulldozer_spatial_equals_step_at_1024(cuda, nccl):
    """``bulldozer_step_spatial`` on one 1024² grid for 10 steps equals
    ``BulldozerCore.step``, every leaf, bit for bit."""
    from gymca_torch.parallel.mesh import make_mesh
    from gymca_torch.parallel.spatial_env import bulldozer_step_spatial, shard_state

    core = BulldozerCore(1024, 1024)
    mesh = make_mesh(1)
    ref = core.initial_state(rng.split(rng.key(3), 1))
    state = shard_state(ref.clone(), mesh)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    for a in ki.draw_actions(gen, 10, 1):
        state, out = bulldozer_step_spatial(core, state, a, mesh)
        ref, r_out = core.step(ref, a)
        for x, y in [(state.grid, ref.grid), (state.key, ref.key), (state.done, ref.done),
                     (state.steps_elapsed, ref.steps_elapsed),
                     (state.reward_accumulated, ref.reward_accumulated),
                     (out.reward, r_out.reward), (out.info["hit"], r_out.info["hit"])]:
            assert torch.equal(x, y)
        for k in ref.context:
            assert torch.equal(state.context[k], ref.context[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("size", [64, 256])
def test_advanced_spatial_on_the_card_matches_the_cpu(cuda, nccl, size):
    """``advanced_step_spatial`` at 64² and 256² for 5 steps: the card (NCCL
    mesh) equals the CPU (a gloo mesh beside it), every leaf, bit for bit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from gymca_torch.parallel.mesh import make_mesh
    from gymca_torch.parallel.spatial_env import advanced_step_spatial

    env = AdvancedForestFireBulldozerEnv(size, size, key=rng.key(0), num_envs=1)
    (_, ctx), _ = env.reset()
    pe = {k: v[0] for k, v in ctx["per_env_context"].items()}
    pe["position"] = ctx["position"][0]
    shared = ctx["shared_context"]
    cpu_pe = {k: v.cpu() for k, v in pe.items()}
    cpu_shared = {k: v.cpu() if torch.is_tensor(v) else v for k, v in shared.items()}
    mesh = make_mesh(1)
    cpu_mesh = DeviceMesh.from_group(dist.new_group(backend="gloo"), "cpu",
                                     mesh_dim_names=("data",))
    for a in ([4, 1], [1, 1], [7, 0], [3, 1], [4, 0]):
        a = torch.tensor(a, dtype=torch.int32, device=cuda)
        g, pe, r, d = advanced_step_spatial(env.ca, pe["true_grid"], pe, shared, a, pe["key"],
                                            mesh)
        cg, cpu_pe, cr, cd = advanced_step_spatial(env.ca, cpu_pe["true_grid"], cpu_pe,
                                                   cpu_shared, a.cpu(), cpu_pe["key"],
                                                   cpu_mesh)
        assert torch.equal(g.cpu(), cg) and torch.equal(r.cpu(), cr) and torch.equal(d.cpu(), cd)
        for k in pe:
            assert torch.equal(pe[k].cpu(), cpu_pe[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("batched", [False, True])
def test_bulldozer_spatial_steps_equal_step_at_the_windy_cells_size(cuda, nccl, batched):
    """The windy cell's 268 M cells as one 16384² grid
    (``bulldozer_step_spatial``) and as 4096 envs of 256² on a (1, 1) mesh
    (``bulldozer_step_batched_spatial``): 10 steps with no host sync, every
    leaf equal to ``BulldozerCore.step``."""
    from gymca_torch.parallel import spatial_env as se
    from gymca_torch.parallel.mesh import make_2d_mesh, make_mesh

    if batched:
        core, n, mesh = BulldozerCore(256, 256), 4096, make_2d_mesh(1, 1)
        shard, step = se.shard_state_batched, se.bulldozer_step_batched_spatial
    else:
        core, n, mesh = BulldozerCore(16384, 16384), 1, make_mesh(1)
        shard, step = se.shard_state, se.bulldozer_step_spatial
    ref = core.initial_state(rng.split(rng.key(0), n))
    state = shard(ref.clone(), mesh)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    for i, a in enumerate(ki.draw_actions(gen, 10, n)):
        with no_host_sync():
            state, out = step(core, state, a, mesh)
        ref, r_out = core.step(ref, a)
        got = tensor_leaves((state, out.reward, out.terminated, out.info["hit"]))
        want = tensor_leaves((ref, r_out.reward, r_out.terminated, r_out.info["hit"]))
        assert len(got) == len(want) and all(map(torch.equal, got, want)), i


@pytest.mark.gpu
def test_advanced_spatial_steps_at_the_cells_sizes_on_nccl(cuda, nccl):
    """``advanced_step_spatial`` on one 4096² grid for 5 steps with no host
    sync: cells in {0, 1, 2}, rewards finite in [-1, 0], fire burning; and
    ``advanced_step_batched_spatial`` at the Advanced cell's 64 x 256² on a
    (1, 1) mesh, 3 steps, equal to 4 of its envs stepped alone, every leaf."""
    from gymca_torch.parallel.mesh import make_2d_mesh, make_mesh
    from gymca_torch.parallel.spatial_env import (
        advanced_step_batched_spatial,
        advanced_step_spatial,
        shard_state_batched,
    )

    mesh, mesh2 = make_mesh(1), make_2d_mesh(1, 1)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)

    def per_env(size, n):
        env = AdvancedForestFireBulldozerEnv(size, size, key=rng.key(0), num_envs=n)
        (_, ctx), _ = env.reset()
        return env, dict(ctx["per_env_context"], position=ctx["position"]), ctx["shared_context"]

    def one(pe, i):
        return {k: v[i] for k, v in pe.items()}

    env, pes, shared = per_env(4096, 1)
    pe, fires = one(pes, 0), 0
    for _ in range(5):
        a = ki.adv_actions(gen, 1, 1)[0, 0, :2]
        with no_host_sync():
            grid, pe, reward, _ = advanced_step_spatial(env.ca, pe["true_grid"], pe, shared, a,
                                                        pe["key"], mesh)
        assert ((grid >= 0) & (grid <= 2)).all()
        assert torch.isfinite(reward).all() and -1 <= float(reward) <= 0
        fires += int((grid == 2).sum())
    assert fires > 0

    env, pes, shared = per_env(256, 64)
    block, alone = shard_state_batched(pes, mesh2), [one(pes, i) for i in range(4)]
    for step in range(3):
        acts = ki.adv_actions(gen, 1, 64)[0, :, :2]
        with no_host_sync():
            grids, block, rewards, dones = advanced_step_batched_spatial(
                env.ca, block["true_grid"], block, shared, acts, block["key"], mesh2)
        for i, pe in enumerate(alone):
            g, alone[i], r, d = advanced_step_spatial(env.ca, pe["true_grid"], pe, shared,
                                                      acts[i], pe["key"], mesh)
            assert torch.equal(g, grids[i]) and torch.equal(r, rewards[i]), (step, i)
            assert torch.equal(d, dones[i]), (step, i)
            for k, v in one(block, i).items():
                assert torch.equal(alone[i][k], v), (step, i, k)


@pytest.mark.gpu
def test_bench_scaling_at_one_rank_on_nccl(cuda, nccl):
    """``python3 -m gymca_torch.bench_scaling`` at its default cell (4096 x
    256²) on a world of one rank, 100 steps a run: d = 1 only, K1 once a
    step in every untimed and timed run."""
    from gymca_torch import bench_scaling

    before = wk.windy_fused_step.launches
    (rec,) = bench_scaling.run(bench_scaling.parse_args(["--steps", "100"]))
    assert rec["devices"] == 1 and rec["steps_per_sec"] > 0
    runs = bench_scaling.WARMUP + bench_scaling.REPS
    assert wk.windy_fused_step.launches - before == runs * 100


@pytest.mark.gpu
def test_data_parallel_ppo_at_the_default_cell_on_nccl(cuda, nccl):
    """``DataParallelPPO`` at ``scripts/run``'s defaults on one rank,
    ``train(1)``: K2 checked, 16 gradient all-reduces and one of the
    metrics, finite metrics, the params moved.  From the starting weights,
    TF32 off: DP (its update traced, NCCL kernels on the device), the
    trainer, DP and the trainer within rtol 1e-4, atol 1e-5 of the first
    trainer."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gymca_torch.agents.ppo import EpisodeStatistics, PPOTrainer
    from gymca_torch.parallel.mesh import make_mesh
    from gymca_torch.parallel.sharded import DataParallelPPO
    from gymca_torch.run import args_to_structured_args, build_env, parse_args

    args = args_to_structured_args(parse_args(["-n", "8", "-z", "256"]))
    env, n, steps = build_env(args), args.env.num_envs, args.exp.num_ppo_steps
    assert env.use_fused_ca
    dp = DataParallelPPO(env, args, make_mesh(1), key=rng.key(args.exp.seed))
    start = dp.trainer.agent_state
    with k2_each_env_step(steps, check=True):
        state, history = dp.train(1)
    n_mb = args.ppo.update_epochs * args.ppo.num_minibatches
    assert (dp.trainer.grad_all_reduces, dp.metric_all_reduces) == (n_mb, 1)
    assert finite_metrics(history) and not params_equal(start.params, state.params)

    real_learn, traces = dp.trainer.learn, []

    def traced_learn(*a, **kw):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = real_learn(*a, **kw)
        traces.append(prof)
        return out

    def dp_iteration(traced):
        dp.trainer.agent_state = start
        dp.trainer.learn = traced_learn if traced else real_learn
        try:
            return dp.train_iteration(*dp.init_carry())
        finally:
            dp.trainer.learn = real_learn

    def trainer_iteration():
        tr = PPOTrainer(env, args, key=rng.key(args.exp.seed))
        obs, info = env.reset()
        return tr.train_iteration(tr.agent_state, EpisodeStatistics.create(n), obs,
                                  torch.zeros(n, dtype=torch.bool, device=cuda), info,
                                  rng.split(tr.key, 1)[0])

    flags = torch.backends.cudnn
    saved = flags.allow_tf32, flags.deterministic
    flags.allow_tf32, flags.deterministic = False, True
    try:
        runs = [dp_iteration(True), trainer_iteration(), dp_iteration(False),
                trainer_iteration()]
    finally:
        flags.allow_tf32, flags.deterministic = saved
    want = runs[1]
    for got in runs[:1] + runs[2:]:
        for g in want[0].params:
            for k, v in want[0].params[g].items():
                torch.testing.assert_close(got[0].params[g][k], v, rtol=1e-4, atol=1e-5)
        for k, v in want[-1].items():
            torch.testing.assert_close(got[-1][k].float(), v.float(), rtol=1e-4, atol=1e-5)
    nccl_kernels = [e for e in traces[0].events() if e.device_type == DeviceType.CUDA
                    and not e.name.startswith("nccl:")
                    and ("nccl" in e.name.lower() or "onerank" in e.name.lower())]
    assert nccl_kernels


# --- slice 10: the trainer's determinism and the tools of scripts/ ----------------------


@pytest.mark.gpu
def test_train_iteration_repeats_itself_at_the_default_cell(cuda):
    """``scripts/run``'s defaults (8 envs at 256², 128 steps, 4 minibatches
    of 256): ``train_iteration`` twice from one carry gives the same params
    and metrics bit for bit (the JAX trainer's iteration is pure,
    ``tests/test_ppo.py:71``), and the caller's cuDNN flags are left as they
    were."""
    from gymca_torch.agents.ppo import EpisodeStatistics, PPOTrainer
    from gymca_torch.run import args_to_structured_args, build_env, parse_args

    args = args_to_structured_args(parse_args(["-n", "8", "-z", "256"]))
    assert (args.exp.num_ppo_steps, args.minibatch_size) == (128, 256)
    env = build_env(args)
    assert env.use_fused_ca
    trainer = PPOTrainer(env, args, key=rng.key(args.exp.seed))
    obs, info = env.reset()
    n = args.env.num_envs
    carry = (trainer.agent_state, EpisodeStatistics.create(n), obs,
             torch.zeros(n, dtype=torch.bool, device=cuda), info, trainer.key)
    flags = torch.backends.cudnn
    saved = flags.deterministic, flags.benchmark
    a, b = trainer.train_iteration(*carry), trainer.train_iteration(*carry)
    assert (flags.deterministic, flags.benchmark) == saved
    for g in a[0].params:
        for k in a[0].params[g]:
            assert torch.equal(a[0].params[g][k], b[0].params[g][k]), (g, k)
    for k in a[-1]:
        assert torch.equal(a[-1][k], b[-1][k]), k


@contextlib.contextmanager
def policy_checked(trainer, calls):
    """``trainer.get_action_and_value`` with each call's outputs kept in
    ``calls`` beside ``_policy_eager``'s on the same inputs, under the same
    flags."""
    real = trainer.get_action_and_value

    def checked(agent_state, obs, key):
        got = real(agent_state, obs, key)
        calls.append((got, trainer._policy_eager(agent_state.params, obs[0],
                                                 trainer._policy_features(obs[1]), key)))
        return got

    trainer.get_action_and_value = checked
    try:
        yield
    finally:
        del trainer.get_action_and_value


def assert_policy_calls_equal(calls, n):
    assert len(calls) == n
    for step, (got, want) in enumerate(calls):
        assert len(got) == len(want) == 4
        for name, a, b in zip(("actions", "logprobs", "value", "key"), got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (step, name)


def default_cell_trainer(cuda):
    from gymca_torch.agents.ppo import EpisodeStatistics, PPOTrainer
    from gymca_torch.run import args_to_structured_args, build_env, parse_args

    args = args_to_structured_args(parse_args(["-n", "8", "-z", "256"]))
    env = build_env(args)
    assert env.use_fused_ca
    trainer = PPOTrainer(env, args, key=rng.key(args.exp.seed))
    obs, info = env.reset()
    n = args.env.num_envs
    carry = (trainer.agent_state, EpisodeStatistics.create(n), obs,
             torch.zeros(n, dtype=torch.bool, device=cuda), info, trainer.key)
    return trainer, carry


@pytest.mark.gpu
def test_policy_graph_replays_equal_the_eager_policy_at_the_default_cell(cuda):
    """8 envs at 256², 128 steps: the first call captures the policy's graph
    and every call of the rollout replays it; at each step its actions,
    log-probs, value and next key equal the eager body's bit for bit."""
    trainer, carry = default_cell_trainer(cuda)
    steps = trainer.args.exp.num_ppo_steps
    calls = []
    with policy_checked(trainer, calls):
        trainer.rollout(*carry)
    assert (trainer.policy_graph_captures, trainer.policy_graph_replays) == (1, steps)
    assert_policy_calls_equal(calls, steps)


@pytest.mark.gpu
def test_policy_graph_reads_the_params_an_iteration_moved(cuda):
    """After a ``train_iteration`` has made new params, a rollout under them
    replays the same graph on them: equal to the eager body under the new
    params, and not to the policy under the old."""
    trainer, carry = default_cell_trainer(cuda)
    steps = trainer.args.exp.num_ppo_steps
    before = []
    with policy_checked(trainer, before):
        moved = trainer.train_iteration(*carry)[0]
    after = []
    with policy_checked(trainer, after):
        trainer.rollout(moved, *carry[1:])
    assert (trainer.policy_graph_captures, trainer.policy_graph_replays) == (1, 2 * steps)
    assert_policy_calls_equal(before, steps)
    assert_policy_calls_equal(after, steps)
    assert not torch.equal(after[0][0][1], before[0][0][1])  # the first step's log-probs


def small_trainer(cuda, **exp_kw):
    from gymca_torch.agents.ppo import EpisodeStatistics, PPOTrainer

    n, size, steps = 4, 64, 8
    env = AdvancedForestFireBulldozerEnv(size, size, key=rng.key(0), num_envs=n)
    trainer = PPOTrainer(env, trainer_args(n, size, steps, **exp_kw))
    obs, info = env.reset()
    carry = (trainer.agent_state, EpisodeStatistics.create(n), obs,
             torch.zeros(n, dtype=torch.bool, device=cuda), info, trainer.key)
    return trainer, carry


@pytest.mark.gpu
def test_policy_graph_captures_once_a_batch_shape(cuda):
    """4 envs at 64² with the position features on (a feature input): the
    rollout captures once; half the batch captures a second graph; the
    whole batch again replays the first.  Every call equals the eager
    body."""
    from gymca_torch.agents.ppo import cudnn_deterministic

    trainer, carry = small_trainer(cuda, position_features=True)
    steps = trainer.args.exp.num_ppo_steps
    calls = []
    with policy_checked(trainer, calls):
        trainer.rollout(*carry)
        assert trainer.policy_graph_captures == 1
        state, _, (grid, context), _, _, key = carry
        half = {"position": context["position"][:2]}
        with cudnn_deterministic():
            trainer.get_action_and_value(state, (grid[:2], half), key)
            assert trainer.policy_graph_captures == 2
            trainer.get_action_and_value(state, (grid, context), key)
    assert (trainer.policy_graph_captures, trainer.policy_graph_replays) == (2, steps + 2)
    assert calls[-2][0][0].shape == (2, trainer.n_action_heads)
    assert_policy_calls_equal(calls, steps + 2)


@pytest.mark.gpu
def test_policy_graph_is_captured_anew_when_tf32_flips(cuda):
    """A rollout with cuDNN's TF32 on, one with it off, one with it on
    again: two captures, and each rollout equals the eager body under its
    own flags."""
    trainer, carry = small_trainer(cuda)
    steps = trainer.args.exp.num_ppo_steps
    flags = torch.backends.cudnn
    saved = flags.allow_tf32
    calls = []
    try:
        with policy_checked(trainer, calls):
            for tf32, captures in ((True, 1), (False, 2), (True, 2)):
                flags.allow_tf32 = tf32
                trainer.rollout(*carry)
                assert trainer.policy_graph_captures == captures
    finally:
        flags.allow_tf32 = saved
    assert trainer.policy_graph_replays == 3 * steps
    assert_policy_calls_equal(calls, 3 * steps)


def eager_rollout(trainer, carry):
    """``trainer``'s rollout with the env half in eager ops
    (``PPOTrainer._step_once``, the CPU's loop): the carry entering each
    step, the carry after the last, and the rows."""
    from gymca_torch.agents.ppo import cudnn_deterministic

    carries, rows = [], []
    with cudnn_deterministic():
        for _ in range(trainer.args.exp.num_ppo_steps):
            carries.append(carry)
            carry, row = trainer._step_once(carry)
            rows.append(row)
    return carries, carry, rows


def assert_trees_equal(got, want, what):
    from gymca_torch.agents.ppo import _leaves

    got, want = _leaves(got), _leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want], what
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (what, path)


@contextlib.contextmanager
def step_carries_kept(trainer, start, seen):
    """``trainer.get_action_and_value``, called once a rollout step, with a
    copy of the env carry entering each step kept in ``seen``: ``start`` at
    the first step, then the carry the step graph holds in its inputs."""
    from gymca_torch.agents.ppo import _tree_map

    real = trainer.get_action_and_value

    def kept(agent_state, obs, key):
        held = list(trainer._step_graphs.values())[-1].args[4] if seen else start
        seen.append(_tree_map(torch.clone, held))
        return real(agent_state, obs, key)

    trainer.get_action_and_value = kept
    try:
        yield
    finally:
        del trainer.get_action_and_value


@pytest.mark.gpu
def test_step_graph_replays_equal_the_eager_env_half_at_the_default_cell(cuda):
    """8 envs at 256², 128 steps: the rollout captures the step graph at its
    first step and replays it at every step; the carry entering each step,
    each step's storage row and the carry after the last equal the eager
    env half's (``_step_once``) bit for bit."""
    trainer, carry = default_cell_trainer(cuda)
    steps = trainer.args.exp.num_ppo_steps
    seen = []
    with step_carries_kept(trainer, carry[1:5], seen):
        out, storage = trainer.rollout(*carry)
    assert (trainer.step_graph_captures, trainer.step_graph_replays) == (1, steps)
    assert (trainer.policy_graph_captures, trainer.policy_graph_replays) == (1, steps)
    carries, last, rows = eager_rollout(trainer, carry)
    assert len(seen) == len(carries) == len(rows) == steps
    for t in range(steps):
        assert_trees_equal(seen[t], carries[t][1:5], f"carry entering step {t}")
        assert_trees_equal(storage.replace(**{f: getattr(storage, f)[t] for f in
                                              storage.__dataclass_fields__}), rows[t],
                           f"row {t}")
    assert_trees_equal(out, last, "carry after the last step")


def halved(carry):
    """The first two envs of a carry, the shared context whole, new episode
    statistics (as ``DataParallelPPO`` cuts a rank's block)."""
    from gymca_torch.agents.ppo import EpisodeStatistics

    state, _, (rgb, context), done, info, key = carry
    context = dict(context, position=context["position"][:2], time=context["time"][:2],
                   per_env_context={k: v[:2] for k, v in context["per_env_context"].items()})
    return (state, EpisodeStatistics.create(2), (rgb[:2], context), done[:2],
            {k: v[:2] for k, v in info.items()}, key)


@pytest.mark.gpu
def test_step_graph_captures_once_a_batch_shape(cuda):
    """4 envs at 64² with position features, reward shaping (douse's max
    pool among it) and kickstart on: the rollout captures once; half the
    batch captures a second graph; the whole batch again replays the first,
    with no host sync.  Each rollout equals the eager env half."""
    from gymca_torch.agents.ppo import EpisodeStatistics, PPOTrainer, Storage

    env = AdvancedForestFireBulldozerEnv(64, 64, key=rng.key(0), num_envs=4)
    args = trainer_args(4, 64, 8, position_features=True)
    ppo = args.ppo
    ppo.shape_tree_coef, ppo.shape_dist_coef, ppo.shape_douse_coef = 20.0, 2.0, 20.0
    ppo.kickstart_coef = 1.0
    trainer = PPOTrainer(env, args)
    assert trainer._shaping and trainer._kickstart and trainer._use_features
    obs, info = env.reset()
    carry = (trainer.agent_state, EpisodeStatistics.create(4), obs,
             torch.zeros(4, dtype=torch.bool, device=cuda), info, trainer.key)
    for i, (c, captures) in enumerate(((carry, 1), (halved(carry), 2), (carry, 2))):
        with no_host_sync() if i == 2 else contextlib.nullcontext():
            got = trainer.rollout(*c)
        assert trainer.step_graph_captures == captures
        _, last, rows = eager_rollout(trainer, c)
        assert_trees_equal(got[0], last, f"rollout {i}'s carry")
        assert_trees_equal(got[1], Storage.stack(rows), f"rollout {i}'s storage")
    assert trainer.step_graph_replays == 3 * args.exp.num_ppo_steps
    assert got[1].grid_obs.shape[1] == 4


@pytest.mark.gpu
def test_what_a_rollout_returns_is_its_own(cuda):
    """The carry and storage a rollout hands back hold no buffer of the
    step graph and stay as they were through a second rollout from another
    carry and a ``train_iteration``; the passed-through terrain and shared
    context are the caller's own tensors."""
    from gymca_torch.agents.ppo import _leaves, _tree_map
    from gymca_torch.envs.advanced import TERRAIN_KEYS

    trainer, carry = small_trainer(cuda)
    first = trainer.rollout(*carry)
    kept = _tree_map(torch.clone, first)
    (graph,) = trainer._step_graphs.values()
    held = {x.untyped_storage().data_ptr() for _, x in _leaves((graph.args, graph.out))
            if isinstance(x, torch.Tensor)}
    context = carry[2][1]
    own = {id(v) for v in context["shared_context"].values()} | {
        id(context["per_env_context"][k]) for k in TERRAIN_KEYS}
    for (path, a), (_, b) in zip(_leaves(first[0][1:5]), _leaves(carry[1:5])):
        assert (a is b) == (id(b) in own), path
    for path, x in _leaves(first):
        if isinstance(x, torch.Tensor):
            assert x.untyped_storage().data_ptr() not in held, path
    trainer.rollout(*first[0])
    trainer.train_iteration(*carry)
    assert trainer.step_graph_captures == 1
    torch.cuda.synchronize()
    assert_trees_equal(first, kept, "the first rollout's output")


def first_launch_on_each_input_set():
    """A ``launch_recorder`` keep rule: K1's first launch on each params
    tensor (or the tensor it views), one per input set of a breakdown."""
    last = [None]

    def keep(i, args, kw):
        root = args[2] if args[2]._base is None else args[2]._base
        new, last[0] = root is not last[0], root
        return new

    return keep


@own_process("profiler")
@pytest.mark.gpu
@pytest.mark.parametrize("envs,steps", [(256, 20), (4096, 3)])
def test_profile_step_entry_point_on_the_card(cuda, capsys, envs, steps):
    """``python3 -m gymca_torch.profile_step`` at 256 and at its 4096 envs of
    256²: every part with the device's numbers, K1 launched on every kernel
    part and equal to its plain version on each input set's first launch."""
    from gymca_torch import profile_step

    before = wk.windy_fused_step.launches
    with ki.launch_recorder(profile_step, "windy_fused_step",
                            first_launch_on_each_input_set()) as recorded:
        out = profile_step.main(["--envs", str(envs), "--steps", str(steps)])
    launched = wk.windy_fused_step.launches - before
    assert launched >= steps * (1 + 3 + 1) * (1 + len(profile_step.KERNEL_CASES))
    assert len(recorded) == len(profile_step.KERNEL_CASES)
    assert all(windy_equals_plain(*r) for r in recorded)
    for name, t in out.items():
        assert t["host_us"] > 0 and t["busy_us_per_step"] > 0, name
    for label in profile_step.KERNEL_CASES:
        t = out[f"kernel only ({label})"]
        assert t["k1_device_us"] > 0 and t["k1_bound_us"] > 0
    assert "kernel only (pure no-op)" in capsys.readouterr().out


@own_process("profiler")
@pytest.mark.gpu
@pytest.mark.parametrize("envs,steps", [(256, 20), (4096, 3)])
def test_exp_split_entry_point_on_the_card(cuda, envs, steps):
    """``python3 -m gymca_torch.probes.exp_split`` at 256 and at its 4096
    envs of 256²: the six fractions, each with K1's device time, K1 equal to
    its plain version on each fraction's first launch."""
    from gymca_torch.probes import exp_split

    before = wk.windy_fused_step.launches
    with ki.launch_recorder(exp_split, "windy_fused_step",
                            first_launch_on_each_input_set()) as recorded:
        out = exp_split.main(["--envs", str(envs), "--steps", str(steps)])
    assert wk.windy_fused_step.launches - before >= 6 * steps * 5
    assert len(out) == len(exp_split.FRACTIONS) == len(recorded)
    assert all(windy_equals_plain(*r) for r in recorded)
    assert all(t["k1_device_us"] > 0 for t in out.values())
    assert all(busy > 0 for _, busy in device_readings(out))


def device_readings(result):
    """``(part, device busy µs a step)`` of every part a tool's result traced:
    its parts' ``busy_us_per_step`` (None where the profiler read no device
    time) and ``exp_advanced_split``'s ``<variant>_device_busy_us``."""
    if isinstance(result, dict) and "busy_us_per_step" in result:
        yield "", result["busy_us_per_step"]
    elif isinstance(result, dict):
        for k, v in result.items():
            if k.endswith("_device_busy_us"):
                yield k, v
            else:
                yield from device_readings(v)
    elif isinstance(result, list):
        for v in result:
            yield from device_readings(v)


ADVANCED_TOOLS = [  # at their default cells (and exp_advanced_split at 8 envs), steps cut
    ("bench_advanced", ["--envs", "8", "--size", "256", "--steps", "3"]),
    ("profile_advanced", ["--envs", "8", "--size", "256", "--steps", "3"]),
    ("exp_advanced_split", ["--envs", "8", "--steps", "3"]),
    ("exp_advanced_split", ["--envs", "64", "--size", "256", "--steps", "2"]),
    ("validate_fused_ca", ["256", "64", "100"]),
    ("exp_policy_ceiling", ["--envs", "8", "--size", "256", "--steps", "20"]),
]


@own_process("profiler")
@pytest.mark.gpu
@pytest.mark.parametrize("tool,argv", ADVANCED_TOOLS,
                         ids=[f"{t}-{a[a.index('--envs') + 1] if '--envs' in a else a[1]}"
                              for t, a in ADVANCED_TOOLS])
def test_advanced_tool_entry_points_on_the_card(cuda, tool, argv):
    """The tools of ``scripts/`` on K2: K2 launched and equal to its plain
    version on its first launch, every traced part with device time;
    ``validate_fused_ca`` passes, ``exp_policy_ceiling``'s returns are finite,
    ``exp_advanced_split``'s stubbed variants launch no K2 and leave no stub."""
    import importlib

    import gymca_torch.envs.advanced as advanced

    mod = importlib.import_module(f"gymca_torch.{tool}")
    before = ak.alexandridis_fused_step.launches
    with contextlib.ExitStack() as stack:
        recorded = [stack.enter_context(ki.alexandridis_recorder({0}, m))
                    for m in (advanced, mod) if hasattr(m, "alexandridis_fused_step")]
        out = mod.main(argv)
    assert ak.alexandridis_fused_step.launches > before
    recorded = sum(recorded, [])
    assert recorded and all(alexandridis_equals_plain(*r) for r in recorded)
    assert all(busy > 0 for _, busy in device_readings(out))
    if tool == "validate_fused_ca":
        assert out == 0
    if tool == "exp_policy_ceiling":
        assert all(math.isfinite(r["mean_return"]) for r in out)
    if tool == "exp_advanced_split":
        k2 = out["k2_launches"]
        assert k2["step_no_ca"] == k2["obs_iso"] == 0
        assert min(k2[v] for v in ("full", "step_only", "step_no_obs", "ca_iso")) > 0
        assert advanced.alexandridis_fused_step is ak.alexandridis_fused_step


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["windy", "advanced"])
def test_bench_on_the_card_equals_its_cpu_run(cuda, path):
    """``gymca_torch.bench`` at 128² (K1, and K2's 128-column tiles) on the
    card and on the CPU (plain versions): the last run's end states equal
    bit for bit, every run's per-step reward sums within 1e-6 (float32 sums
    over the envs in the card's order and the CPU's); 5 x steps launches of
    the path's kernel on the card."""
    from gymca_torch import bench
    from gymca_torch.interop import advanced_obs_to_numpy, env_state_to_numpy

    size, n, steps = 128, 8, 12
    if path == "windy":
        counter, measure = wk.windy_fused_step, bench.measure_windy
    else:
        counter, measure = ak.alexandridis_fused_step, bench.measure_advanced
    before = counter.launches
    on_card = measure(size, n, steps, cuda)
    assert counter.launches - before == on_card["launches"] == (bench.WARM + bench.REPS) * steps
    on_cpu = measure(size, n, steps, "cpu")
    assert on_card["path"] != on_cpu["path"]  # the kernel there, its plain version here
    for card_run, cpu_run in zip(on_card["runs"], on_cpu["runs"]):
        torch.testing.assert_close(card_run["reward_sums"].cpu(), cpu_run["reward_sums"],
                                   rtol=1e-6, atol=1e-6)
    a, b = on_card["runs"][-1], on_cpu["runs"][-1]
    if path == "windy":
        core = BulldozerCore(size, size, device="cpu")
        got = env_state_to_numpy(a["states"])
        want = env_state_to_numpy(b["states"])
        got["grid"] = BulldozerCore(size, size, device=cuda).materialize_grid(
            a["states"]).cpu().numpy()
        want["grid"] = core.materialize_grid(b["states"]).numpy()
    else:
        got = advanced_obs_to_numpy(a["obs"], a["info"])
        want = advanced_obs_to_numpy(b["obs"], b["info"])

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}{k}.")
        elif isinstance(tree, (tuple, list)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}{i}.")
        else:
            yield prefix, np.asarray(tree)

    want_leaves = dict(leaves(want))
    for name, v in leaves(got):
        np.testing.assert_array_equal(v, want_leaves[name], err_msg=name)
    assert on_card["done_fraction"] == on_cpu["done_fraction"]


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["windy", "advanced"])
def test_bench_at_the_cells_sizes_on_the_card(cuda, path):
    """``gymca_torch.bench`` at bench.py's cells, 200 steps a run: 5 x 200
    launches of the path's kernel and none of the other, reward sums in
    [-envs, 0], the kernel equal to its plain version in the untimed runs."""
    import gymca_torch.envs.bulldozer as bulldozer
    from gymca_torch import bench

    steps, keep = 200, {0, 199, 399}
    if path == "windy":
        n, measure, check = 4096, bench.measure_windy, windy_equals_plain
        recorder = ki.launch_recorder(bulldozer, "windy_fused_step", keep)
    else:
        n, measure, check = 64, bench.measure_advanced, alexandridis_equals_plain
        recorder = ki.alexandridis_recorder(keep)
    counters = (wk.windy_fused_step, ak.alexandridis_fused_step)
    before = [c.launches for c in counters]
    with recorder as recorded:
        m = measure(256, n, steps, cuda)
    runs = (bench.WARM + bench.REPS) * steps
    assert [c.launches - b for c, b in zip(counters, before)] == (
        [runs, 0] if path == "windy" else [0, runs])
    sums = torch.stack([r["reward_sums"] for r in m["runs"]])
    assert torch.isfinite(sums).all() and (sums <= 0).all() and (sums >= -n).all()
    assert len(recorded) == 3 and all(check(*r) for r in recorded)


@own_process("profiler")
@pytest.mark.gpu
def test_steps_with_spans_on_equal_the_steps_with_them_off(cuda):
    """Spans on inside a profiler session, with any host wait an error: a
    windy and an Advanced step equal the spans-off steps bit for bit, and
    every kernel launch of the windy step lies inside a program span (K1's
    two inside ``gymca.ca``, the key chain's four threefry launches inside
    ``gymca.rng``).  Launches are the host's runtime calls: after earlier
    sessions in a process the profiler drops a few kernels' device events
    (on the card, the step's first threefry kernels), never the host's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gymca_torch.core.env import tree_map
    from gymca_torch.utils import metrics

    n = 64
    core = BulldozerCore(256, 256)
    start = core.initial_state(torch.as_tensor(key_data(25, n)).to(cuda))
    r = np.random.default_rng(26)
    windy_actions = torch.tensor(np.stack([r.integers(0, 9, n), r.integers(0, 2, n)], -1),
                                 dtype=torch.int32, device=cuda)
    env = AdvancedForestFireBulldozerEnv(64, 64, key=rng.key(3), num_envs=4)
    obs, info = env.reset()
    actions = torch.tensor([[1, 1, 0], [4, 0, 0], [8, 1, 0], [2, 0, 0]], dtype=torch.int32,
                           device=cuda)

    states = [start.clone(), start.clone()]  # step_batched updates the grid in place

    def windy():
        return core.step_batched(states.pop(), windy_actions)

    terminated = torch.tensor([True, False, True, False], device=cuda)

    def advanced():
        out = env.stateless_step(actions, obs, info)
        return env.conditional_reset(out[:2] + (terminated,) + out[3:], actions)

    def leaves(tree):
        found = []
        tree_map(lambda x: found.append(x) if isinstance(x, torch.Tensor) else None, tree)
        return found

    off = [leaves(windy()), leaves(advanced())]
    metrics.reset()
    metrics.enable()
    sessions, on = [], []
    try:
        for step in (windy, advanced):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    on.append(leaves(step()))
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
            sessions.append(prof.profiler.kineto_results.events())
    finally:
        metrics.disable()
    assert metrics.snapshot()["step_batched/ca"][0] == 1
    for a, b in zip(on, off):
        assert len(a) == len(b) > 5
        assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))

    # A kernel's launch: the host's runtime call (cudaLaunchKernel, K1's
    # cudaLaunchKernelExC), named by the device kernel of its correlation id
    # where the profiler kept one.
    events = sessions[0]
    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    launches = {e.correlation_id(): e.start_ns() for e in cpu
                if e.name().startswith(("cudaLaunchKernel", "cuLaunchKernel"))}
    kernels = {e.correlation_id(): e.name() for e in events
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
               and not e.name().startswith(("Memcpy", "Memset"))}
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in cpu
             if e.is_user_annotation() and e.name().startswith(metrics.SPAN_PREFIX)]
    assert set(kernels) <= set(launches)
    assert len(set(kernels) & set(launches)) > 100
    within = {}
    for corr, t in launches.items():
        names = {name for s, e, name in spans if s <= t < e}
        assert names, kernels.get(corr, corr)
        for name in names:
            within.setdefault(name, []).append(corr)
    assert len(within["gymca.step_batched"]) == len(launches)
    assert len(within["gymca.ca"]) == 2
    assert all("windy_" in kernels[c] for c in within["gymca.ca"] if c in kernels)
    assert len(within["gymca.rng"]) == 4  # one threefry launch a draw
    assert all("threefry_kernel" in kernels[c] for c in within["gymca.rng"] if c in kernels)
    assert any(c in kernels for c in within["gymca.rng"])


# --- the key chain's threefry kernel (csrc/threefry.cu) ------------------------------


def tensor_leaves(tree):
    from gymca_torch.core.env import tree_map

    found = []
    tree_map(lambda x: found.append(x) if isinstance(x, torch.Tensor) else None, tree)
    return found


def same_bits(got, want, what=""):
    assert (got.device, got.dtype, got.shape) == (want.device, want.dtype, want.shape), what
    if got.is_floating_point():  # bit patterns: -0 is not 0
        as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}[got.element_size()]
        got, want = got.view(as_int), want.view(as_int)
    assert torch.equal(got, want), what


def kernel_and_eager(draw, monkeypatch):
    """``draw()`` through the kernel, the launches it made, and ``draw()``
    again with every hash on the eager int64 path on the same keys."""
    before = rng.threefry_launch.launches
    got = draw()
    launched = rng.threefry_launch.launches - before
    with monkeypatch.context() as m:
        m.setattr(rng, "threefry_launch", rng.threefry_plain)
        want = draw()
    return got, launched, want


def card_keys(seed, n, cuda):
    return torch.as_tensor(key_data(seed, n)).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("num,n", [(1, 4096), (2, 4096), (6, 4096), (4096, 16), (3, None)])
def test_threefry_split_equals_the_eager_chain_on_the_card(cuda, monkeypatch, num, n):
    keys = card_keys(40, n, cuda) if n else rng.key(40)
    got, launched, want = kernel_and_eager(lambda: rng.split(keys, num), monkeypatch)
    same_bits(got, want)
    assert launched == 1


@pytest.mark.gpu
@pytest.mark.parametrize("data", [0, 1, 7, 8, 2**32 - 1])
def test_threefry_fold_in_equals_the_eager_chain_on_the_card(cuda, monkeypatch, data):
    keys = card_keys(41, 4096, cuda)
    got, launched, want = kernel_and_eager(lambda: rng.fold_in(keys, data), monkeypatch)
    same_bits(got, want)
    assert launched == 1


@pytest.mark.gpu
@pytest.mark.parametrize("n,shape", [(64, ()), (64, (3, 3)), (64, (256, 256)), (64, (0,)),
                                     (4096, (3, 3))])
def test_threefry_random_bits_equal_the_eager_chain_on_the_card(cuda, monkeypatch, n, shape):
    keys = card_keys(42, n, cuda)
    got, launched, want = kernel_and_eager(lambda: rng.random_bits(keys, shape), monkeypatch)
    same_bits(got, want)
    assert launched == (1 if got.numel() else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.0, 5.0), (rng._NORMAL_LO, 1.0), (1e-20, 3.0)])
@pytest.mark.parametrize("n,shape", [(4096, (3, 3)), (64, (256, 256))])
def test_threefry_uniform_equals_the_eager_chain_on_the_card(cuda, monkeypatch, lo, hi, n,
                                                             shape):
    keys = card_keys(43, n, cuda)
    got, launched, want = kernel_and_eager(lambda: rng.uniform(keys, shape, lo, hi),
                                           monkeypatch)
    same_bits(got, want)
    assert launched == 1


@pytest.mark.gpu
@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 7), (0, 8), (4, 89), (0, 2**31 - 1),
                                   (-(2**31), 2**31 - 1)])
def test_threefry_randint_equals_the_eager_chain_on_the_card(cuda, monkeypatch, lo, hi):
    keys = card_keys(44, 4096, cuda)
    got, launched, want = kernel_and_eager(lambda: rng.randint(keys, (7,), lo, hi),
                                           monkeypatch)
    same_bits(got, want)
    assert launched == 1


COMPOSED_DRAWS = {
    "choice": (lambda k: rng.choice(k, 3, (256, 256), (0.1, 0.9, 0.0)), 1),
    "permutation": (lambda k: rng.permutation(k[0], 65536), 4),
    "poisson": (lambda k: rng.poisson(k, 1.0, (64, 64), max_count=8), 16),
    "normal": (lambda k: rng.normal(k, (64, 64)), 1),
    "exponential": (lambda k: rng.exponential(k, (64, 64)), 1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(COMPOSED_DRAWS))
def test_threefry_composed_draws_equal_the_eager_chain_on_the_card(cuda, monkeypatch, name):
    draw, launches = COMPOSED_DRAWS[name]
    keys = card_keys(45, 64, cuda)
    got, launched, want = kernel_and_eager(lambda: draw(keys), monkeypatch)
    same_bits(got, want)
    assert launched == launches


@pytest.mark.gpu
def test_threefry_on_sliced_and_broadcast_keys_on_the_card(cuda, monkeypatch):
    """The key chain's operands are slices of a split: read in place, they
    draw what their contiguous copies and the eager chain draw."""
    pair = rng.split(card_keys(46, 4096, cuda), 3)
    draws = [lambda x: rng.split(x, 2), lambda x: rng.fold_in(x, 8),
             lambda x: rng.random_bits(x, (3, 3)), lambda x: rng.uniform(x, (5,), 0.0, 5.0),
             lambda x: rng.randint(x, (), 0, 85)]
    for k in (pair[:, 1], pair[::3, :, 0:2][:, 2], pair.transpose(0, 1),
              rng.key(47).expand(4096, 2)):
        assert not k.is_contiguous()
        for draw in draws:
            got, launched, want = kernel_and_eager(lambda: draw(k), monkeypatch)
            same_bits(got, want)
            same_bits(got, draw(k.contiguous()))
            assert launched == 1


@pytest.mark.gpu
def test_threefry_wrapper_on_the_card(cuda):
    """An empty draw launches nothing; a bad operand raises before any
    launch; no draw waits for the device."""
    keys = card_keys(48, 8, cuda)
    before = rng.threefry_launch.launches
    assert rng.uniform(keys, (0, 3)).shape == (8, 0, 3)
    assert rng.split(keys[:0], 4).shape == (0, 4, 2)
    for bad in (keys.to(torch.int32), keys[:, :1]):
        with pytest.raises(ValueError):
            rng.threefry_launch(bad, 4, "bits")
    assert rng.threefry_launch.launches == before
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = rng.randint(rng.fold_in(rng.split(keys, 3)[:, 1], 5), (9,), 0, 8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.device.type == "cuda" and rng.threefry_launch.launches == before + 3


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["derive_step_key", "split", "fold_in", "uniform", "randint",
                                  "choice", "uniform_3x3"])
def test_threefry_draws_of_the_cells_equal_the_eager_chain_on_the_card(cuda, monkeypatch,
                                                                        name):
    """The draws of the two env cells on their own keys (4096 windy, 64
    Advanced; the fresh grids' keys a strided slice of a split, as the env
    reads them), one launch a draw (``derive_step_key``: four)."""
    from gymca_torch.envs.bulldozer import derive_step_key

    windy, adv = rng.split(rng.key(0), 4096), rng.split(rng.key(1), 64)
    fresh = rng.split(adv)[:, 0]
    draw, launches = {
        "derive_step_key": (lambda: derive_step_key(windy), 4),
        "split": (lambda: rng.split(windy, 6), 1),
        "fold_in": (lambda: rng.fold_in(adv, 7), 1),
        "uniform": (lambda: rng.uniform(adv), 1),
        "randint": (lambda: rng.randint(adv, (), 1, 8), 1),
        "choice": (lambda: rng.choice(fresh, 3, (256, 256), (0.1, 0.9, 0.0)), 1),
        "uniform_3x3": (lambda: rng.uniform(windy, (3, 3), 0.0, 5.0), 1),
    }[name]
    got, launched, want = kernel_and_eager(draw, monkeypatch)
    for g, w in zip(*((t if isinstance(t, tuple) else (t,)) for t in (got, want))):
        same_bits(g, w)
    assert launched == launches


def counted_run(run, monkeypatch):
    """``run()`` through the kernel with any eager hash on the card an error,
    and its launches; then ``run()`` with every hash eager."""
    counter = rng.threefry_launch
    with monkeypatch.context() as m:
        m.setattr(rng, "threefry2x32", None)  # the eager hash is never called
        before = counter.launches
        got = run()
        torch.cuda.synchronize()
        launched = counter.launches - before
    with monkeypatch.context() as m:
        m.setattr(rng, "threefry_launch", rng.threefry_plain)
        want = run()
    assert len(got) == len(want) > 10
    for i, (g, w) in enumerate(zip(got, want)):
        same_bits(g, w, i)
    return launched


@pytest.mark.gpu
def test_windy_steps_with_the_kernel_equal_the_eager_key_chain(cuda, monkeypatch):
    """4096 envs at 256², reset and 1000 ``step_batched`` steps: the keys
    drawn by the kernel (4 launches a step) and by the eager chain give the
    same states and outputs, leaf for leaf."""
    n, steps = 4096, 1000
    core = BulldozerCore(256, 256)
    keys = rng.split(rng.key(49), n)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(50)
    actions = ki.draw_actions(gen, steps, n)
    counter, reset_launches = rng.threefry_launch, []

    def run():
        before = counter.launches
        states = core.initial_state(keys)
        reset_launches.append(counter.launches - before)
        start = tensor_leaves(states.clone())
        rewards, dones = [], []
        for a in actions:
            states, out = core.step_batched(states, a)
            rewards.append(out.reward)
            dones.append(states.done)
        return start + tensor_leaves((states, out)) + [torch.stack(rewards),
                                                        torch.stack(dones)]

    launched = counted_run(run, monkeypatch)
    assert reset_launches[0] > 0 and launched == reset_launches[0] + 4 * steps


@pytest.mark.gpu
def test_advanced_steps_with_the_kernel_equal_the_eager_key_chain(cuda, monkeypatch):
    """64 envs at 256², reset and 200 steps of ``stateless_step`` +
    ``conditional_reset``: kernel keys (10 launches a step) and eager keys
    give the same leaves."""
    n, steps = 64, 200
    env = AdvancedForestFireBulldozerEnv(256, 256, key=rng.key(51), num_envs=n)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(52)
    actions = ki.adv_actions(gen, steps, n)
    counter, reset_launches = rng.threefry_launch, []

    def run():
        before = counter.launches
        obs, info = env.reset()
        reset_launches.append(counter.launches - before)
        start = tensor_leaves((obs, info))
        sums = []
        obs, info, last = ki.adv_run(env, obs, info, actions, sums)
        return start + tensor_leaves((obs, info, last)) + [torch.stack(sums)]

    launched = counted_run(run, monkeypatch)
    assert reset_launches[0] > 0 and launched == reset_launches[0] + 10 * steps


@pytest.mark.gpu
def test_cases_of_the_own_processes_pass(cuda, own_processes):
    """Every ``own_process`` case passes in its group's process."""
    if own_processes is None:
        pytest.skip("this is one of the processes it waits for")
    failed = {}
    for group, (proc, out) in own_processes.items():
        rc = proc.wait(timeout=900)
        out.seek(0)
        text = out.read().decode(errors="replace")
        print(f"--- the {group} process:", text[-20000:])
        if rc:
            failed[group] = text[-5000:]
    assert not failed, failed
