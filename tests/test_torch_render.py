"""The port's renders and metrics against the JAX package's, on the CPU.

Each render of the port and of the JAX package draws an equal state and is
rasterised through ``figure_to_rgb`` (Agg): the pixels must be equal.  The
envs are built directly (no ``gym.make``), so both titles come from
``title``.  Then ``MetricsLogger``'s scalars read back from its event file,
its GIF fallback for videos, and ``profile_trace``'s trace file.
"""

import json

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from matplotlib.figure import Figure  # noqa: E402

from gymca_torch import interop  # noqa: E402
from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv as TAdvanced  # noqa: E402
from gymca_torch.gym_env import ForestFireBulldozerEnv, ForestFireHelicopterEnv  # noqa: E402
from gymca_torch.utils import render  # noqa: E402
from gymca_torch.utils.metrics import TRACE_FILE, MetricsLogger, profile_trace  # noqa: E402
from gymca_tpu.envs.advanced import AdvancedForestFireBulldozerEnv as JAdvanced  # noqa: E402
from gymca_tpu.envs.bulldozer import ForestFireBulldozerEnv as JBulldozer  # noqa: E402
from gymca_tpu.envs.helicopter import ForestFireHelicopterEnv as JHelicopter  # noqa: E402
from gymca_tpu.utils import render as j_render  # noqa: E402

ADV_ENVS, ADV_SIZE = 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pixels(fig):
    assert isinstance(fig, Figure)
    rgb = render.figure_to_rgb(fig)
    plt.close(fig)
    assert rgb.ndim == 3 and rgb.shape[2] == 3 and rgb.dtype == np.uint8
    return rgb


def assert_same_pixels(got_fig, want_fig):
    got, want = pixels(got_fig), pixels(want_fig)
    assert got.shape == want.shape
    assert np.array_equal(got, want), f"{int((got != want).any(-1).sum())} pixels differ"


# --- the gymnasium envs ---------------------------------------------------------------


@pytest.mark.parametrize("env_cls,jax_cls,shape,actions", [
    (ForestFireHelicopterEnv, JHelicopter, (8, 8), [3, 1, 5, 8]),
    (ForestFireHelicopterEnv, JHelicopter, (12, 20), [0, 7]),
    (ForestFireBulldozerEnv, JBulldozer, (16, 16), [[3, 1], [5, 1], [8, 0]]),
])
def test_env_render_matches_jax(env_cls, jax_cls, shape, actions):
    env, want = env_cls(*shape, seed=1, device="cpu"), jax_cls(*shape, seed=1)
    env.reset(seed=1)
    want.reset(seed=1)
    for a in actions:
        env.step(a)
        want.step(a)
    np.testing.assert_array_equal(env.grid, want.grid)
    assert_same_pixels(env.render(), want.render())


# --- the Advanced env -----------------------------------------------------------------


@pytest.fixture(scope="module")
def advanced_pair():
    """(JAX env, port env): same starting key, so the same terrain, XLA path."""
    jenv = JAdvanced(ADV_SIZE, ADV_SIZE, key=jax.random.key(0), num_envs=ADV_ENVS)
    key = torch.tensor(np.asarray(jax.random.key_data(jenv.starting_key)).astype(np.int64))
    tenv = TAdvanced(ADV_SIZE, ADV_SIZE, key=key, num_envs=ADV_ENVS, use_fused_ca=False,
                     device="cpu")
    return jenv, tenv


def test_advanced_render_matches_jax(advanced_pair):
    """After a reset, after steps that shoot (dousing overlay), with one env
    made night, and from the numpy form of the obs."""
    jenv, tenv = advanced_pair
    jobs, jinfo = jenv.reset()
    tobs, tinfo = tenv.reset()
    assert_same_pixels(tenv.render(tobs, tinfo, env_idx=1), jenv.render(jobs, jinfo, env_idx=1))
    actions = np.array([[3, 1, 0], [7, 1, 0]], np.int32)
    for _ in range(3):
        jstep = jenv.stateless_step(jax.numpy.asarray(actions), jobs, jinfo)
        jobs, _, _, _, jinfo = jenv.conditional_reset(jstep, jax.numpy.asarray(actions))
        tstep = tenv.stateless_step(torch.tensor(actions), tobs, tinfo)
        tobs, _, _, _, tinfo = tenv.conditional_reset(tstep, torch.tensor(actions))
    assert np.asarray(jobs[1]["per_env_context"]["dousing_count"]).any()
    assert_same_pixels(tenv.render(tobs, tinfo, env_idx=0), jenv.render(jobs, jinfo, env_idx=0))
    night_j = np.asarray(jobs[1]["per_env_context"]["is_night"]).copy()
    night_j[1] = 1
    jobs[1]["per_env_context"]["is_night"] = night_j
    tobs[1]["per_env_context"]["is_night"] = torch.tensor(night_j)
    assert_same_pixels(tenv.render(tobs, tinfo, env_idx=1), jenv.render(jobs, jinfo, env_idx=1))
    # the numpy form of the obs renders the same
    host_rgb, host_context, host_info = interop.advanced_obs_to_numpy(tobs, tinfo)
    assert_same_pixels(render.render_advanced(tenv, (host_rgb, host_context), host_info, 0),
                       jenv.render(jobs, jinfo, env_idx=0))


@pytest.mark.parametrize("method", ["altitude_render", "density_render", "vegitation_render"])
def test_terrain_renders_match_jax(advanced_pair, method):
    jenv, tenv = advanced_pair
    got, want = getattr(tenv, method)(), getattr(jenv, method)()
    assert len(got) == len(want) == ADV_ENVS
    for g, w in zip(got, want):
        assert_same_pixels(g, w)


def test_plot_grid_attribute_matches_jax():
    for grid in (np.zeros((4, 4)), np.random.default_rng(0).normal(size=(6, 9))):
        assert_same_pixels(render.plot_grid_attribute(torch.tensor(grid), "Altitude"),
                           j_render.plot_grid_attribute(grid, "Altitude"))


def test_local_window():
    g = np.arange(25).reshape(5, 5)
    for pos, radius in (((0, 0), 1), ((4, 4), 2), ((2, 1), 3)):
        np.testing.assert_array_equal(render.local_window(g, pos, radius, fill=-1),
                                      j_render.local_window(g, pos, radius, fill=-1))
    w = render.local_window(g, (4, 4), 2, fill=-1)
    assert w[0, 0] == 12 and w[2, 2] == 24 and w[4, 4] == -1


# --- metrics --------------------------------------------------------------------------


def test_metrics_logger_scalars_read_back(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    logger = MetricsLogger(log_dir=str(tmp_path), run_name="r", config={"lr": 0.1})
    for step in range(3):
        logger.log(step * 10, {"loss": 0.5 - step * 0.125, "SPS": 100 + step, "tag": "x"})
    logger.close()
    acc = EventAccumulator(str(tmp_path / "r"))
    acc.Reload()
    assert {"loss", "SPS"} <= set(acc.Tags()["scalars"])
    loss = acc.Scalars("loss")
    assert [e.step for e in loss] == [0, 10, 20]
    assert [e.value for e in loss] == [0.5, 0.375, 0.25]
    assert [e.value for e in acc.Scalars("SPS")] == [100, 101, 102]


def test_metrics_logger_video_falls_back_to_a_gif(tmp_path):
    from PIL import Image

    logger = MetricsLogger(log_dir=str(tmp_path), run_name="v")
    frames = np.random.default_rng(0).integers(0, 256, (3, 8, 10, 3), dtype=np.uint8)
    logger.log_video("rollout", frames, step=7)
    logger.close()
    gif = tmp_path / "v" / "rollout_7.gif"
    assert gif.exists()
    with Image.open(gif) as im:
        assert im.size == (10, 8) and im.n_frames == 3


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(True, str(tmp_path / "prof")):
        torch.ones(8).cumsum(0)
    trace = json.loads((tmp_path / "prof" / TRACE_FILE).read_text())
    assert any("cumsum" in e.get("name", "") for e in trace["traceEvents"])
    with profile_trace(False, str(tmp_path / "off")):
        pass
    assert not (tmp_path / "off").exists()
