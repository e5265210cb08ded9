"""The step breakdowns of ``scripts/`` on the port against the scripts' own
arithmetic, on the CPU at small sizes (tolerance 0 throughout).

``profile_step`` and ``probes.exp_split`` (K1): their synthetic inputs
element for element, K1's plain version against the JAX kernel in Pallas
interpret mode, the key chain of part (c).  ``bench_advanced``,
``profile_advanced`` and ``exp_advanced_split`` (K2): their actions and
seeds, K2 alone on the JAX fused path (interpreted, zero draws, as
``tests/test_torch_advanced.py`` does), the observation build alone, and the
stubbed steps against the JAX env with the same stubs.  The scripts are
imported by path and read, not edited.  ``probes.timing.time_steps``, which
times every part, is held to its contract without a card.
"""

import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gymca_torch.envs.advanced as tadvanced
import gymca_torch.ops.alexandridis_kernel as ak
import gymca_tpu.ops.pallas_alexandridis as pa
from gymca_torch import bench_advanced, exp_advanced_split, interop, profile_advanced
from gymca_torch import profile_step, rng
from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv as TEnv
from gymca_torch.envs.bulldozer import BulldozerCore as TCore
from gymca_torch.envs.bulldozer import derive_step_key
from gymca_torch.ops.windy_kernel import windy_fused_step_plain
from gymca_torch.probes import exp_split
from gymca_torch.probes.timing import time_steps
from gymca_tpu.envs.advanced import AdvancedForestFireBulldozerEnv as JEnv
from gymca_tpu.envs.bulldozer import BulldozerCore as JCore
from gymca_tpu.ops.pallas_kernels import windy_fused_step, windy_weights_from_roll
from gymca_tpu.ops.stencil import NEIGHBOR_OFFSETS, telescoped_box_coeffs

ROOT = Path(__file__).resolve().parent.parent
BF16 = ("exp_slope", "veg_den_factor")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def script(name):
    """``scripts/<name>.py`` as a module, imported by path."""
    path = ROOT / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"script_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kd(keys):
    return np.asarray(jax.random.key_data(keys))


# --- probes.timing.time_steps --------------------------------------------------------


def test_time_steps_restores_before_every_run_and_times_only_the_host_on_the_cpu():
    calls = []
    t = time_steps(lambda k: calls.append(("run", k)), 40, "x", "cpu",
                   reset=lambda: calls.append("reset"), reps=3)
    assert calls == ["reset", ("run", 40)] * 4  # one untimed run, then the best of 3
    assert t["host_us"] >= 0
    assert t["busy_us_per_step"] is t["kernels_per_step"] is t["idle_share"] is None


class FakeProfile:
    """``torch.profiler.profile``'s stand-in: each session takes the next of
    ``SESSIONS``, ``(device kernel events, host launches)``, kernels of 2 µs
    each 5 µs apart."""

    SESSIONS: list = []

    def __init__(self, activities):
        self.kernels, self.launched = self.SESSIONS.pop(0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        from types import SimpleNamespace

        from torch.autograd import DeviceType

        def event(device_type, name, start):
            return SimpleNamespace(device_type=device_type, name=name,
                                   time_range=SimpleNamespace(start=start, end=start + 2.0))

        return ([event(DeviceType.CUDA, "k", 5.0 * i) for i in range(self.kernels)]
                + [event(DeviceType.CPU, "cudaLaunchKernel", 0.0)] * self.launched
                + [event(DeviceType.CPU, "aten::add", 0.0)])

    def key_averages(self):
        from types import SimpleNamespace

        from torch.autograd import DeviceType

        return [SimpleNamespace(device_type=DeviceType.CUDA, device_time_total=2.0 * self.kernels,
                                count=self.kernels, key="k")]


@pytest.fixture
def fake_profiler(monkeypatch):
    import torch.profiler

    from gymca_torch.probes import timing

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(timing.time, "sleep", lambda s: None)
    monkeypatch.setattr(FakeProfile, "SESSIONS", [])
    return FakeProfile.SESSIONS


@pytest.mark.parametrize("first", [(0, 0), (0, 8), (3, 8)],
                         ids=["no events", "no device events", "most kernel events lost"])
def test_profile_steps_takes_a_short_session_again(fake_profiler, first, capsys):
    """A session with no device event, or kernel events for fewer than half
    the host's launches, is taken again (``reset()`` first); the next is
    kept and the line says two sessions were taken."""
    from gymca_torch.probes.timing import profile_steps

    fake_profiler += [first, (8, 8)]
    calls = []
    out = profile_steps(lambda: calls.append("run"), 4, "x", "card",
                        reset=lambda: calls.append("reset"))
    assert calls == ["run", "reset", "run"] and not fake_profiler
    assert out["sessions"] == 2 and out["kernels_per_step"] == 2.0
    assert out["busy_us_per_step"] == 8 * 2.0 / 4
    assert "2 session(s) taken, the kept one with 8 kernel events of 8 launches" in \
        capsys.readouterr().out


def test_profile_steps_keeps_a_session_that_lost_a_few_kernel_events(fake_profiler, capsys):
    """As every session on an H100 does (42 of 50 launches kept): kept at
    once."""
    from gymca_torch.probes.timing import profile_steps

    fake_profiler += [(42, 50)]
    out = profile_steps(lambda: None, 10, "x", "card")
    assert out["sessions"] == 1 and out["kernels_per_step"] == 4.2
    assert "1 session(s) taken, the kept one with 42 kernel events of 50 launches" in \
        capsys.readouterr().out


def test_profile_steps_gives_up_after_every_session_came_back_empty(fake_profiler,
                                                                    monkeypatch, capsys):
    from gymca_torch.probes import timing

    monkeypatch.setattr(timing, "SESSION_TRIES", 3)
    fake_profiler += [(0, 5)] * 3
    runs = []
    assert timing.profile_steps(lambda: runs.append(1), 2, "x", "card") is None
    assert len(runs) == 3 and not fake_profiler
    assert "not measured" in capsys.readouterr().out


# --- profile_step ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def windy128():
    """The script's start at 14 envs of 128² (rows and columns 100 lie on
    it): the JAX package's states and the port's, from key(0)."""
    n = 14
    jcore = JCore(128, 128)
    jstates = jax.vmap(jcore.initial_state)(jax.random.split(jax.random.key(0), n))
    tcore = TCore(128, 128, device="cpu")
    tstates = tcore.initial_state(rng.split(rng.key(0, device="cpu"), n))
    return n, jcore, jstates, tcore, tstates


def test_start_states_equal_jax(windy128):
    _, _, jstates, _, tstates = windy128
    np.testing.assert_array_equal(tstates.grid.numpy(), np.asarray(jstates.grid))
    np.testing.assert_array_equal(tstates.key.numpy(), kd(jstates.key))


def test_kernel_inputs_are_the_scripts(windy128):
    """profile_step.py:64-71 and :88-98: rolls, weights and the four (N, 6)
    params tables, element for element."""
    n, jcore, _, tcore, _ = windy128
    key = jax.random.key(0)
    rolls = jax.random.uniform(key, (n, 3, 3))
    weights = windy_weights_from_roll(jcore._wind, rolls)
    params = jnp.zeros((n, 6), jnp.int32)
    do_ca = (jnp.arange(n) % 7 == 0).astype(jnp.int32)
    params = params.at[:, 0].set(do_ca).at[:, 3].set(1 - do_ca)
    params = params.at[:, 1].set(100).at[:, 2].set(100)
    params_none = params.at[:, 0].set(0)
    want = {"1/7 fire": params, "all fire": params.at[:, 0].set(1),
            "none fire, all shoot": params_none, "pure no-op": params_none.at[:, 3].set(0)}
    t_rolls, t_weights, cases = profile_step.synthetic_k1_inputs(tcore,
                                                                 rng.key(0, device="cpu"), n)
    np.testing.assert_array_equal(t_rolls.numpy(), np.asarray(rolls))
    np.testing.assert_array_equal(t_weights.numpy(), np.asarray(weights))
    assert tuple(cases) == profile_step.KERNEL_CASES == tuple(want)
    for label, p in want.items():
        np.testing.assert_array_equal(cases[label].numpy(), np.asarray(p), err_msg=label)


def test_k1_plain_equals_the_interpreted_jax_kernel_on_the_scripts_inputs(windy128):
    """3 launches of each case, the grid carried: JAX's kernel interpreted
    on the script's (N, 6) params, the port's plain version on their first
    four columns (the JAX kernel reads only those: it gives the same grids
    and counts on the first four alone).  Grids equal after every launch;
    counts equal where the JAX kernel defines them (all three where do_ca,
    hit where shoot alone)."""
    n, _, jstates, tcore, tstates = windy128
    _, weights, cases = profile_step.synthetic_k1_inputs(tcore, rng.key(0, device="cpu"), n)
    for label, params6 in cases.items():
        jgrid, tgrid = jstates.grid, tstates.grid.clone()
        p4 = params6[:, :4].contiguous()
        e0, c0 = torch.zeros((n, 0), dtype=torch.int32), torch.zeros((n,), dtype=torch.int32)
        for step in range(3):
            jgrid, jcounts = windy_fused_step(jgrid, jnp.asarray(weights.numpy()),
                                              jnp.asarray(params6.numpy()), empty=0, tree=3,
                                              fire=25, interpret=True)
            _, tcounts = windy_fused_step_plain(tgrid, weights, p4, e0, c0, empty=0, tree=3,
                                                fire=25)
            np.testing.assert_array_equal(tgrid.numpy(), np.asarray(jgrid),
                                          err_msg=f"{label} step {step}")
            do_ca, shoot = p4[:, 0].numpy() > 0, p4[:, 3].numpy() > 0
            jc, tc = np.asarray(jcounts), tcounts.numpy()
            np.testing.assert_array_equal(tc[do_ca], jc[do_ca], err_msg=label)
            alone = ~do_ca & shoot
            np.testing.assert_array_equal(tc[alone, 2], jc[alone, 2], err_msg=label)
        if label == "all fire":
            assert (tgrid != tstates.grid).any()  # the fire spread


def test_key_chain_part_equals_the_scripts_derive(windy128):
    """profile_step.py:102-116: the keys carried and the rolls of 3 steps
    of ``vmap(derive)``, bit for bit."""
    _, _, jstates, _, tstates = windy128

    def derive(key):
        carry, sub = jax.random.split(key)
        k_ca, _ = jax.random.split(sub)
        (k0,) = jax.random.split(k_ca, 1)
        return carry, jax.random.uniform(k0, (3, 3), dtype=jnp.float32)

    jkeys, tkeys = jstates.key, tstates.key
    for _ in range(3):
        jkeys, jrolls = jax.vmap(derive)(jkeys)
        tkeys, trolls = derive_step_key(tkeys)
        np.testing.assert_array_equal(tkeys.numpy(), kd(jkeys))
        np.testing.assert_array_equal(trolls.numpy(), np.asarray(jrolls))


def test_actions_are_the_scripts():
    """profile_step.py:49-54: ``key, k = split(key)``, ``randint(k, (N, 2),
    0, 2)``, 4 steps from key(0)."""
    key, want = jax.random.key(0), []
    for _ in range(4):
        key, k = jax.random.split(key)
        want.append(jax.random.randint(k, (9, 2), 0, 2, dtype=jnp.int32))
    got = profile_step.action_draws(rng.key(0, device="cpu"), 4, 9)
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


def test_profile_step_runs_on_the_cpu(capsys):
    out = profile_step.main(["--size", "16", "--envs", "8", "--steps", "2", "--device-cpu"])
    assert set(out) == {"full step_batched", "derive only", "epilogue-ish",
                        *(f"kernel only ({c})" for c in profile_step.KERNEL_CASES)}
    printed = capsys.readouterr().out
    for label in ("full step_batched:", "kernel only (1/7 fire):", "derive only:",
                  "epilogue-ish:"):
        assert label in printed


# --- probes.exp_split ------------------------------------------------------------------


def test_exp_split_grid_and_work_lists_are_the_scripts():
    """exp_split.py:181-199 and :206-209: the grid, and 3 steps of each
    fraction's work list (weights, params), element for element."""
    n, h, w = 8, 32, 32
    key = jax.random.key(0)
    jgrid = jax.random.choice(key, jnp.array([0, 3, 25], jnp.int8), (n, h, w),
                              p=jnp.array([0.099, 0.9, 0.001]))
    np.testing.assert_array_equal(exp_split.start_grid(n, h, w, "cpu").numpy(),
                                  np.asarray(jgrid))
    jkeys = jax.random.split(jax.random.key(1), 3)
    tkeys = rng.split(rng.key(1, device="cpu"), 3)
    for _, p_ca, p_mod in exp_split.FRACTIONS:
        weights, params = exp_split.work_lists(tkeys, n, h, w, p_ca, p_mod)
        for t, k in enumerate(jkeys):
            u = jax.random.uniform(k, (n,))
            do_ca = u < p_ca
            shoot = (u >= p_ca) & (u < p_ca + p_mod)
            rows = jax.random.randint(jax.random.fold_in(k, 1), (n,), 0, h)
            cols = jax.random.randint(jax.random.fold_in(k, 2), (n,), 0, w)
            jw = jnp.where(jax.random.uniform(jax.random.fold_in(k, 3), (n, 8)) < 0.7,
                           8, 0).astype(jnp.int32)
            jp = jnp.stack([do_ca.astype(jnp.int32), rows, cols,
                            (shoot | do_ca).astype(jnp.int32)], axis=-1)
            np.testing.assert_array_equal(weights[t].numpy(), np.asarray(jw))
            np.testing.assert_array_equal(params[t].numpy(), np.asarray(jp))


def test_exp_split_runs_on_the_cpu():
    out = exp_split.main(["--envs", "8", "--size", "16", "--steps", "2", "--device-cpu"])
    assert list(out) == [name.strip() for name, _, _ in exp_split.FRACTIONS]


# --- bench_advanced -----------------------------------------------------------------------


def test_bench_advanced_actions_are_the_scripts():
    """bench_advanced.py:34-37 over ``split(key(2), 3)``."""
    n = 5
    want = []
    for k in jax.random.split(jax.random.key(2), 3):
        want.append(jnp.stack([jax.random.randint(k, (n,), 0, 9),
                               jax.random.randint(jax.random.fold_in(k, 1), (n,), 0, 2),
                               jnp.zeros((n,), jnp.int32)], axis=1))
    got = bench_advanced.step_actions(rng.split(rng.key(2, device="cpu"), 3), n)
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    got = exp_advanced_split.actions(rng.split(rng.key(2, device="cpu"), 3), n)
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


def test_bench_advanced_runs_both_paths_on_the_cpu(capsys):
    out = bench_advanced.main(["--envs", "2", "--size", "16", "--steps", "2", "--device-cpu"])
    assert [r["use_fused_ca"] for r in out] == [False, True]
    printed = capsys.readouterr().out
    assert "XLA CA:" in printed and "fused Pallas CA:" in printed


# --- profile_advanced ---------------------------------------------------------------------


def port_env(jenv, **kw):
    """The port's env on the CPU with the JAX env's key and settings: it
    draws the same terrain from the key."""
    key = torch.tensor(np.asarray(jax.random.key_data(jenv.starting_key)).astype(np.int64))
    return TEnv(jenv.nrows, jenv.ncols, key=key, num_envs=jenv.num_envs, device="cpu", **kw)


@pytest.fixture
def zero_draws(monkeypatch):
    """The JAX kernel interpreted (its PRNG a zero stub) and the port's draws
    zero, as tests/test_torch_advanced.py holds the fused path."""
    monkeypatch.setattr(pa, "alexandridis_fused_step",
                        functools.partial(pa.alexandridis_fused_step, interpret=True))
    monkeypatch.setattr(ak, "alexandridis_draws", lambda seeds, h, w: (
        torch.zeros((seeds.shape[0], h, w)),
        torch.zeros((seeds.shape[0], h, w), dtype=torch.int64)))


def test_kernel_alone_equals_the_scripts_on_the_jax_fused_path(zero_draws):
    """profile_advanced.py:119-144 at 2 envs of 16x128 (the JAX kernel's
    tile gate), 3 launches carrying grid and age from the reset, seeds
    [5, 9]: grid and ages bit for bit."""
    jenv = JEnv(16, 128, key=jax.random.key(0), num_envs=2, use_pallas_ca=True)
    tenv = port_env(jenv, use_fused_ca=True)
    obs, _ = jenv.reset()
    per_env, shared, ca = obs[1]["per_env_context"], obs[1]["shared_context"], jenv.ca
    wm = shared["winds"][per_env["wind_index"]]
    wind_rows = jnp.stack([wm[:, 1 + dr, 1 + dc] for dr, dc in NEIGHBOR_OFFSETS], axis=-1)
    seeds = jnp.tile(jnp.asarray([[5, 9]], jnp.int32), (2, 1))
    grid = per_env["true_grid"].astype(jnp.int32)
    age = per_env["fire_age"].astype(jnp.float32)
    for _ in range(3):
        g2, a2 = pa.alexandridis_fused_step(
            grid, age, per_env["dousing_count"].astype(jnp.int32),
            per_env["veg_den_factor"].astype(jnp.float32),
            per_env["exp_slope"].astype(jnp.float32), wind_rows, seeds,
            empty=0, tree=1, fire=2, layer_coeffs=telescoped_box_coeffs(ca.burn_layer_weights),
            dousing_border=float(ca._dousing_border), dousing_inner=float(ca._dousing_inner),
            fire_age_min=int(ca.fire_age_min), fire_age_max=int(ca.fire_age_max))
        grid, age = g2.astype(grid.dtype), a2.astype(age.dtype)
    tobs, _ = tenv.reset()
    x, kw = profile_advanced.kernel_inputs(tenv, tobs)
    assert x["seeds"].tolist() == [[5, 9], [5, 9]]
    tgrid, tage = profile_advanced.run_kernel(x, kw, 3)
    np.testing.assert_array_equal(tgrid.numpy(), np.asarray(grid))
    np.testing.assert_array_equal(tage.numpy(), np.asarray(age))
    assert (tgrid != x["grid"]).any()


@pytest.fixture(scope="module")
def adv32():
    """4 Advanced envs at 32² from key(0), JAX and port (the port draws the
    same terrain from the key), with their resets."""
    jenv = JEnv(32, 32, key=jax.random.key(0), num_envs=4)
    tenv = exp_advanced_split.make_env(32, 4, device="cpu")
    return jenv, jenv.reset(), tenv, tenv.reset()


def test_obs_build_alone_equals_the_scripts(adv32):
    """profile_advanced.py:157-174: the vmapped build of the reset grid at
    positions (5, 7) with zero actions, bit for bit."""
    jenv, (jobs, _), tenv, (tobs, _) = adv32
    per_env, shared = jobs[1]["per_env_context"], jobs[1]["shared_context"]
    acts = jnp.zeros((4, 3), jnp.int32)
    positions = jnp.tile(jnp.asarray([[5, 7]]), (4, 1))
    rgb, _ = jax.vmap(jenv.build_observation_on_extensions,
                      in_axes=(0, 0, 0, jenv._per_env_in_axes(), None))(
        per_env["true_grid"], positions, acts, per_env, shared)
    got = profile_advanced.run_obs(tenv, tobs, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(rgb))


def test_profile_advanced_runs_on_the_cpu(capsys):
    out = profile_advanced.main(["--envs", "2", "--size", "16", "--steps", "2",
                                 "--device-cpu"])
    assert set(out) == {"kernel", "obs", "full XLA CA", "full fused Pallas CA"}
    assert "fused CA kernel alone:" in capsys.readouterr().out


# --- exp_advanced_split -------------------------------------------------------------------


def assert_step_equal(tstep, jstep, tag):
    """Every leaf of a ``stateless_step`` tuple, bit for bit."""
    (t_rgb, t_ctx), t_info = tstep[0], tstep[4]
    rgb, ctx, info = interop.advanced_obs_to_numpy((t_rgb, t_ctx), t_info)
    (j_rgb, j_ctx), j_info = jstep[0], jstep[4]
    bad = [] if np.array_equal(rgb, np.asarray(j_rgb)) else ["rgb"]
    for k, v in j_ctx["per_env_context"].items():
        v = kd(v) if k == "key" else np.asarray(v)
        if k in BF16:
            v = v.view(np.uint16)
        if not np.array_equal(ctx["per_env_context"][k], v):
            bad.append(k)
    bad += [k for k in ("position", "time") if not np.array_equal(ctx[k], np.asarray(j_ctx[k]))]
    bad += ["info." + k for k, v in j_info.items() if not np.array_equal(info[k], np.asarray(v))]
    bad += [name for name, i in (("reward", 1), ("terminated", 2), ("truncated", 3))
            if not np.array_equal(tstep[i].numpy(), np.asarray(jstep[i]))]
    assert not bad, f"{tag}: {bad}"


def run_steps(jenv, jobs, jinfo, tenv, tobs, tinfo, steps):
    """``steps`` stateless steps of both envs with the script's actions of
    ``split(key(1), steps)``, each compared; returns the port's last."""
    jkeys = jax.random.split(jax.random.key(1), steps)
    tacts = exp_advanced_split.actions(rng.split(rng.key(1, device="cpu"), steps),
                                       jenv.num_envs)
    for i in range(steps):
        ja = jnp.stack([jax.random.randint(jkeys[i], (jenv.num_envs,), 0, 9),
                        jax.random.randint(jax.random.fold_in(jkeys[i], 1), (jenv.num_envs,),
                                           0, 2),
                        jnp.zeros((jenv.num_envs,), jnp.int32)], axis=1)
        np.testing.assert_array_equal(tacts[i].numpy(), np.asarray(ja))
        js = jenv.stateless_step(ja, jobs, jinfo)
        ts = tenv.stateless_step(tacts[i], tobs, tinfo)
        assert_step_equal(ts, js, f"step {i}")
        jobs, jinfo, tobs, tinfo = js[0], js[4], ts[0], ts[4]
    return ts


def test_step_no_obs_equals_the_scripts_stubbed_env():
    """exp_advanced_split.py:281-288 and :337-345: the JAX env with its
    observation build a zero stub against the port's ``make_env(...,
    obs_stub=True)`` (its ``_observe`` stubbed), 3 steps leaf for leaf: the
    RGB is zero and everything else as the real step; the stub's reset too."""
    jenv = script("exp_advanced_split").make_env(32, 4, obs_stub=True)
    tenv = exp_advanced_split.make_env(32, 4, obs_stub=True, device="cpu")
    jobs, jinfo = jenv.reset()
    tobs, tinfo = tenv.reset()
    last = run_steps(jenv, jobs, jinfo, tenv, tobs, tinfo, 3)
    assert not last[0][0].any()
    acts = torch.zeros((4, 3), dtype=torch.int32)
    done = (True, False, False, False)
    step = (last[0], last[1], torch.tensor(done), last[3], last[4])
    assert not tenv.conditional_reset(step, acts)[0][0].any()


def test_step_no_ca_equals_the_scripts_stub_and_launches_no_kernel(monkeypatch):
    """exp_advanced_split.py:348-366: the JAX env on the fused path with
    ``pallas_alexandridis.alexandridis_fused_step`` an identity stub against
    the port's env under ``ca_stubbed()``, 2 envs at 128² (the JAX kernel's
    tile gate), 2 steps leaf for leaf; the stubbed step calls the kernel's
    wrapper (and so its plain version here) not once, the real one every
    step; the stub is gone after the block."""
    monkeypatch.setattr(pa, "alexandridis_fused_step",
                        lambda grid, fire_age, *a, **kw: (grid.astype(jnp.int8),
                                                          fire_age.astype(jnp.float32)))
    calls = []
    real_plain = ak.alexandridis_fused_step_plain
    monkeypatch.setattr(ak, "alexandridis_fused_step_plain",
                        lambda *a, **kw: calls.append(1) or real_plain(*a, **kw))
    jenv = JEnv(128, 128, key=jax.random.key(0), num_envs=2, use_pallas_ca=True)
    assert jenv.use_pallas_ca
    with exp_advanced_split.ca_stubbed():
        tenv = exp_advanced_split.make_env(128, 2, device="cpu", use_fused_ca=True)
        assert tenv.use_fused_ca
        jobs, jinfo = jenv.reset()
        tobs, tinfo = tenv.reset()
        last = run_steps(jenv, jobs, jinfo, tenv, tobs, tinfo, 2)
    assert calls == []
    grid0 = tobs[1]["per_env_context"]["true_grid"]
    assert torch.equal(last[0][1]["per_env_context"]["true_grid"], grid0)
    assert tadvanced.alexandridis_fused_step is ak.alexandridis_fused_step
    tenv.stateless_step(torch.zeros((2, 3), dtype=torch.int32), tobs, tinfo)
    assert calls == [1]


def test_obs_iso_equals_the_scripts(adv32):
    """exp_advanced_split.py:371-382: 3 steps of the isolated RGB build
    carrying the grid, bit for bit."""
    jenv, (jobs, _), tenv, (tobs, _) = adv32
    jper, tper = jobs[1]["per_env_context"], tobs[1]["per_env_context"]
    jpos, tpos = jobs[1]["position"], tobs[1]["position"]
    jgrid, tgrid = jper["true_grid"], tper["true_grid"]
    fa = jnp.zeros((4, 3), jnp.int32)
    for _ in range(3):
        rgb = jax.vmap(lambda g, p, aa, inight, dc: jenv._grid_to_rgb(
            g.astype(jnp.float32), inight, dc, p), in_axes=(0, 0, 0, 0, 0))(
            jgrid, jpos, fa, jper["is_night"], jper["dousing_count"])
        jgrid = jgrid ^ (rgb[..., 0] > 200).astype(jgrid.dtype)
        tgrid = exp_advanced_split.obs_iso_step(tenv, tgrid, tpos, tper["dousing_count"],
                                                tper["is_night"])
        np.testing.assert_array_equal(tgrid.numpy(), np.asarray(jgrid))


def test_ca_iso_seeds_are_the_scripts():
    """exp_advanced_split.py:403-405: the key data of ``fold_in(k, arange(n))``
    for 3 step keys; the JAX script casts them to int32, the port's kernel
    takes the same words as int64."""
    n = 6
    jkeys = jax.random.split(jax.random.key(1), 3)
    want = np.stack([kd(jax.vmap(jax.random.fold_in, (None, 0))(k, jnp.arange(n)))
                     for k in jkeys])
    got = exp_advanced_split.fold_in_range(rng.split(rng.key(1, device="cpu"), 3), n)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_exp_advanced_split_prints_the_scripts_keys(capsys):
    """At 2 envs of 16² on the CPU (the XLA-path counterpart, as the
    script's CPU run): one JSON line holding every key the script prints."""
    out = exp_advanced_split.main(["--size", "16", "--envs", "2", "--steps", "2",
                                   "--device-cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    keys = {"size", "envs", "full_us", "step_only_us", "step_no_obs_us", "step_no_ca_us",
            "obs_iso_us", "reset_overhead_us", "obs_in_situ_us", "ca_in_situ_us",
            "steps_per_sec_full"}
    assert keys <= set(line)
    # the script rounds each difference of the unrounded times to 0.1 µs
    assert abs(line["reset_overhead_us"] - (line["full_us"] - line["step_only_us"])) < 0.11
    assert "ca_iso_us" not in line  # only where the env runs the fused kernel
