"""``python3 -m gymca_torch.run --no-train`` against ``scripts/run``'s
evaluation, on the CPU.

``scripts/run`` has no ``.py`` and is JAX-side, so only this test imports
it, through ``SourceFileLoader``.  Its ``evaluate`` runs on a JAX Advanced
env built once for the module (2 envs x 16², the XLA path, as
``--no-pallas-ca`` sets it) and wrapped to record the actions and rewards;
the port's ``evaluate`` runs the port's env on its XLA-path counterpart with
the same flags.  The random, scripted and params actors must give the same
actions, the env the same float32 rewards, and ``--gif`` the same frames
(tolerance 0 throughout).  Weights cross to the port with ``interop``.
"""

import importlib.machinery
import importlib.util
import subprocess
import sys
from pathlib import Path

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image, ImageSequence  # noqa: E402

from gymca_torch import interop, run  # noqa: E402
from gymca_torch.agents.checkpoint import CheckpointManager  # noqa: E402
from gymca_torch.agents.ppo import PPOTrainer, load_actor  # noqa: E402
from gymca_tpu.agents.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from gymca_tpu.agents.ppo import PPOTrainer as JPPOTrainer  # noqa: E402
from gymca_tpu.agents.ppo import load_actor as j_load_actor  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
N_ENVS, SIZE, STEPS = 2, 16, 24
BASE = ["-n", str(N_ENVS), "-z", str(SIZE), "--no-train", "--no-pallas-ca"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jrun():
    loader = importlib.machinery.SourceFileLoader("scripts_run", str(ROOT / "scripts" / "run"))
    module = importlib.util.module_from_spec(importlib.util.spec_from_loader(loader.name,
                                                                            loader))
    loader.exec_module(module)
    return module


def args_pair(jrun, argv, out_dir):
    """(scripts/run's Args, the port's Args) for the same flags."""
    raw = run.parse_args(argv + ["--out-dir", str(out_dir)])
    ja = jrun.args_to_structured_args(raw)
    ja._pallas_ca, ja._actor, ja._video_every = False, raw.actor, 0
    return ja, run.args_to_structured_args(raw)


@pytest.fixture(scope="module")
def jenv(jrun, tmp_path_factory):
    ja, _ = args_pair(jrun, BASE, tmp_path_factory.mktemp("jenv"))
    return jrun.build_env(ja)


def record(env, recorded):
    """Wrap ``env.stateless_step`` to keep each step's actions and rewards
    as numpy arrays."""
    step = env.stateless_step

    def wrapped(actions, obs, info):
        out = step(actions, obs, info)
        recorded.append((np.asarray(actions), np.asarray(out[1])))
        return out

    return wrapped


def evaluate_both(jrun, jenv, monkeypatch, tmp_path, argv, actor="random"):
    """Run scripts/run's ``evaluate`` and the port's on ``argv``; returns
    (JAX steps, port steps, JAX out dir, port out dir, port result)."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    ja, pa = args_pair(jrun, BASE + argv, jdir)
    _, pa = args_pair(jrun, BASE + argv, pdir)
    want, got = [], []
    monkeypatch.setattr(jenv, "stateless_step", record(jenv, want))
    monkeypatch.setattr(jrun, "build_env", lambda args: jenv)
    jrun.evaluate(ja)
    penv = run.build_env(pa, use_fused_ca=False, device="cpu")
    penv.stateless_step = record(penv, got)
    result = run.evaluate(pa, device="cpu", actor=actor, env=penv)
    return want, got, jdir, pdir, result


def assert_steps_equal(got, want):
    assert len(got) == len(want) > 0
    for t, ((ga, gr), (wa, wr)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(ga, wa, err_msg=f"actions, step {t}")
        assert gr.dtype == wr.dtype == np.float32
        np.testing.assert_array_equal(gr, wr, err_msg=f"rewards, step {t}")


def gif_frames(path):
    with Image.open(path) as im:
        return [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]


def png_pixels(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


# --- the actors -----------------------------------------------------------------------


def test_random_actor_rewards_and_gif_match_scripts_run(jrun, jenv, monkeypatch, tmp_path):
    want, got, jdir, pdir, result = evaluate_both(
        jrun, jenv, monkeypatch, tmp_path, ["--steps", str(STEPS), "--gif"])
    assert_steps_equal(got, want)
    np.testing.assert_array_equal(result.rewards.numpy(), np.stack([r for _, r in want]))
    np.testing.assert_array_equal(result.total_reward.numpy(),
                                  np.sum(np.stack([r for _, r in want]), 0, np.float64))
    for i in range(N_ENVS):
        # Pillow merges equal consecutive frames, so a GIF may hold fewer
        frames, wanted = gif_frames(pdir / f"env{i}.gif"), gif_frames(jdir / f"env{i}.gif")
        assert 1 < len(frames) == len(wanted) <= STEPS
        for f, w in zip(frames, wanted):
            np.testing.assert_array_equal(f, w)
    for name in ("altitude", "density", "vegitation"):
        for i in range(N_ENVS):
            png = f"terrain_{name}_env{i}.png"
            np.testing.assert_array_equal(png_pixels(pdir / png), png_pixels(jdir / png))


def test_scripted_actor_matches_scripts_run(jrun, jenv, monkeypatch, tmp_path):
    want, got, *_ = evaluate_both(jrun, jenv, monkeypatch, tmp_path,
                                  ["--steps", str(STEPS), "--actor", "scripted"], "scripted")
    assert_steps_equal(got, want)


@pytest.mark.parametrize("size,envs,steps", [(16, 2, 24), (32, 1, 100), (100, 3, 500),
                                             (200, 2, 700), (256, 1, 400)])
def test_scripted_actions_match_scripts_run(jrun, size, envs, steps):
    got = run.scripted_actions(size, envs, steps)
    want = jrun.scripted_actions(size, envs, steps)
    assert got.dtype == want.dtype and got.shape == (steps, envs, 3)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def checkpoints(jrun, jenv, tmp_path_factory):
    """A JAX checkpoint of a fresh JAX trainer's state, and the port's
    checkpoint of the same weights carried by ``interop``."""
    root = tmp_path_factory.mktemp("ckpt")
    ja, pa = args_pair(jrun, BASE, root)
    jt = JPPOTrainer(jenv, ja, jax.random.key(5))
    mgr = JCheckpointManager(str(root / "jax"))
    mgr.save_state(1, jt.agent_state, jt.key)
    mgr.close()
    penv = run.build_env(pa, use_fused_ca=False, device="cpu")
    pt = PPOTrainer(penv, pa, device="cpu")
    params = interop.ppo_params_from_numpy(jax.device_get(dict(jt.agent_state.params)), "cpu")
    CheckpointManager(str(root / "port")).save_state(1, pt.agent_state.replace(params=params),
                                                     pt.key)
    return root / "jax", root / "port"


def test_load_actor_matches_jax(jrun, jenv, checkpoints, tmp_path):
    ja, pa = args_pair(jrun, BASE, tmp_path)
    penv = run.build_env(pa, use_fused_ca=False, device="cpu")
    j_get = j_load_actor(str(checkpoints[0]), jenv, ja)
    p_get = load_actor(str(checkpoints[1]), penv, pa, device="cpu")
    jobs, _ = jenv.reset()
    pobs, _ = penv.reset()
    np.testing.assert_array_equal(pobs[0].numpy(), np.asarray(jobs[0]))
    got, want = p_get(pobs[0]), j_get(jobs[0])
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(p_get(pobs[0], pobs[1]).numpy(), got.numpy())


def test_params_actor_matches_scripts_run(jrun, jenv, checkpoints, monkeypatch, tmp_path):
    """``--actor params``: scripts/run restores the JAX checkpoint and the
    port its own checkpoint of the same weights."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    ja, _ = args_pair(jrun, BASE + ["--steps", "8", "--actor", "params", "--params",
                                    str(checkpoints[0])], jdir)
    _, pa = args_pair(jrun, BASE + ["--steps", "8", "--actor", "params", "--params",
                                    str(checkpoints[1])], pdir)
    want, got = [], []
    monkeypatch.setattr(jenv, "stateless_step", record(jenv, want))
    monkeypatch.setattr(jrun, "build_env", lambda args: jenv)
    jrun.evaluate(ja)
    penv = run.build_env(pa, use_fused_ca=False, device="cpu")
    penv.stateless_step = record(penv, got)
    run.evaluate(pa, device="cpu", actor="params", env=penv)
    assert_steps_equal(got, want)


# --- the loop and the writers ---------------------------------------------------------


def test_eval_loop_captures_and_rich_frames():
    pa = run.args_to_structured_args(run.parse_args(BASE))
    env = run.build_env(pa, use_fused_ca=False, device="cpu")
    get_action = run.make_actor(pa, env, "random")
    result = run.eval_loop(env, get_action, 130, record=True)
    every = run.capture_every(130)
    assert every == 2 and len(result.captures) == 65
    assert result.rewards.shape == (130, N_ENVS) and result.total_reward.dtype == torch.float64
    frames = run.rich_frames(result.captures)
    assert len(frames) == N_ENVS
    assert frames[0].shape == (65, SIZE, 3 * SIZE + 4, 3) and frames[0].dtype == np.uint8
    first = result.captures[0]
    np.testing.assert_array_equal(frames[1][0, :, :SIZE], first.agent_rgb[1].numpy())
    np.testing.assert_array_equal(
        frames[1][0], run.compose_rich_frame(first.agent_rgb[1].numpy(),
                                             first.true_rgb[1].numpy(),
                                             first.dousing[1].numpy(),
                                             int(first.wind_index[1])))


def test_cli_writes_the_gif_and_the_terrain_maps(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "gymca_torch.run", "-n", "2", "-z", "16", "--no-train", "--gif",
         "--steps", "8", "--device-cpu", "--out-dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "eval: 8 steps, mean reward/env:" in out.stdout
    names = {p.name for p in tmp_path.iterdir()}
    assert {"env0.gif", "env1.gif"} <= names
    assert {f"terrain_{t}_env{i}.png" for t in ("altitude", "density", "vegitation")
            for i in range(2)} <= names
    assert 1 <= len(gif_frames(tmp_path / "env0.gif")) <= 8


def test_evaluate_asks_for_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(BASE + ["--steps", "2", "--out-dir", str(tmp_path)])


def test_actor_params_needs_params():
    with pytest.raises(SystemExit, match="--params"):
        run.main(BASE + ["--actor", "params", "--device-cpu"])
