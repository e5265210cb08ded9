"""``python3 -m gymca_torch.train_curve`` and ``python3 -m
gymca_torch.eval_policy`` against ``scripts/train_curve.py`` and
``scripts/eval_policy.py``, and the params blob that carries weights
between them.

Both scripts are loaded with ``SourceFileLoader`` and run in this process
at 2 envs x 16² on the XLA path, each once per module.  The trainer is
chaotic over iterations: the 1.4e-6 gap BC leaves in the params grows to
6e-4 over one more curriculum stage, while a stage run from the same params
ends within 1.2e-7.  So, as ``tests/test_torch_ppo.py`` carries weights into
each comparison, the port's trainer starts stage 0 from the JAX trainer's
initial weights and each stage's ``train()`` from the JAX stage's starting
params, after its own carried params are checked against them.
Tolerances are ``tests/test_torch_ppo.py``'s: params within ``PARAM_ATOL``
= 2e-6, metrics within rtol 1e-3 (``SPS`` left out), episodic returns
equal; beside rtol an atol of 1e-6 for metrics that are float32 rounding
noise about zero (in the critic-only iteration, where the policy does not
move, ``policy_loss`` reads -1.2e-7 and -6.0e-8, ``approx_kl`` -9.3e-10
and -3.7e-9).  The evaluations' JSON numbers
and the policies' actions are equal (tolerance 0).
"""

import contextlib
import io
import json
import pickle
import sys
from importlib.machinery import SourceFileLoader
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gymca_torch.agents.ppo as tppo
import gymca_tpu.agents.ppo as jppo
from gymca_torch import eval_policy as teval
from gymca_torch import interop, rng
from gymca_torch import train_curve as tcurve
from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv as TEnv

ROOT = Path(__file__).resolve().parent.parent
PARAM_ATOL = 2e-6  # tests/test_torch_ppo.py
METRIC_RTOL = 1e-3  # tests/test_torch_ppo.py::test_train_iteration_matches_jax
METRIC_NOISE_ATOL = 1e-6
CURVE_ARGV = ["--size", "16", "--num-envs", "2", "--iters", "3", "--seed", "3",
              "--sm-schedule", "2:0.67,1:0.33", "--bc-iters", "1", "--critic-warmup-iters", "1",
              "--shape-tree-coef", "20", "--shape-dist-coef", "2", "--shape-douse-coef", "20",
              "--kickstart-coef", "1.0", "--kickstart-decay", "2", "--centroid-features",
              "--gamma", "0.999", "--tag", "t"]
EVAL_ARGV = ["--envs", "2", "--steps", "40"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_script(name):
    return SourceFileLoader(f"jax_{name}", str(ROOT / "scripts" / f"{name}.py")).load_module()


def run_script_main(module, argv):
    """``module.main()`` with ``argv`` as its command line; its stdout."""
    out = io.StringIO()
    saved = sys.argv
    sys.argv = [module.__file__] + argv
    try:
        with contextlib.redirect_stdout(out):
            module.main()
    finally:
        sys.argv = saved
    return out.getvalue()


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def max_gap(a, b):
    a, b = leaves(a), leaves(b)
    assert sorted(a) == sorted(b)
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


@pytest.fixture(scope="module")
def curves(tmp_path_factory):
    """Both training curves, with what each trainer held at each stage."""
    tmp = tmp_path_factory.mktemp("curve")
    jax_rec = {"train_in": [], "train_out": [], "keys": [], "history": []}
    port_rec = {"carried": [], "train_out": [], "history": []}

    class JaxTrainer(jppo.PPOTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            jax_rec.setdefault("init", jax.device_get(dict(self.agent_state.params)))

        def train(self, *a, **k):
            jax_rec["train_in"].append(jax.device_get(dict(self.agent_state.params)))
            jax_rec["keys"].append(np.asarray(jax.random.key_data(self.key)))
            state, history = super().train(*a, **k)
            jax_rec["train_out"].append(jax.device_get(dict(state.params)))
            jax_rec["history"].append(history)
            return state, history

    class PortTrainer(tppo.PPOTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            if "init" not in port_rec:  # stage 0 starts from the JAX weights
                port_rec["init"] = True
                self.agent_state = self.agent_state.replace(
                    params=interop.ppo_params_from_numpy(jax_rec["init"], self.device))

        def train(self, *a, **k):
            stage = len(port_rec["carried"])
            port_rec["carried"].append(interop.ppo_params_to_numpy(self.agent_state.params))
            port_rec.setdefault("keys", []).append(self.key.numpy().copy())
            self.agent_state = self.agent_state.replace(params=interop.ppo_params_from_numpy(
                jax_rec["train_in"][stage], self.device))
            state, history = super().train(*a, **k)
            port_rec["train_out"].append(interop.ppo_params_to_numpy(state.params))
            port_rec["history"].append(history)
            return state, history

    script = load_script("train_curve")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jppo, "PPOTrainer", JaxTrainer)
        mp.setattr(tppo, "PPOTrainer", PortTrainer)
        run_script_main(script, CURVE_ARGV + ["--out", str(tmp / "jax"), "--save-params",
                                              str(tmp / "jax.pkl")])
        port_blob = tcurve.main(CURVE_ARGV + ["--out", str(tmp / "port"), "--save-params",
                                              str(tmp / "port.pkl"), "--device-cpu"])
    return tmp, jax_rec, port_rec, port_blob


def test_train_curve_stages_match_the_jax_script(curves):
    """Two stages (2 and 1 iterations; BC and a critic-only iteration in
    stage 0): the port's carried params and trainer key at each stage's
    start, and its params at each stage's end, against the JAX script's."""
    _, jax_rec, port_rec, _ = curves
    assert len(jax_rec["train_in"]) == len(port_rec["carried"]) == 2
    for stage in range(2):
        np.testing.assert_array_equal(port_rec["keys"][stage],
                                      jax_rec["keys"][stage].astype(np.int64))
        carried = max_gap(port_rec["carried"][stage], jax_rec["train_in"][stage])
        assert carried <= PARAM_ATOL, (stage, carried)
        end = max_gap(port_rec["train_out"][stage], jax_rec["train_out"][stage])
        moved = max_gap(jax_rec["train_out"][stage], jax_rec["train_in"][stage])
        assert end <= PARAM_ATOL < moved, (stage, end, moved)
    # stage 0's BC moved the params away from the initial weights
    assert max_gap(jax_rec["train_in"][0], jax_rec["init"]) > 1e-4


def test_train_curve_history_matches_the_jax_script(curves):
    _, jax_rec, port_rec, _ = curves
    j_hist = [m for h in jax_rec["history"] for m in h]
    t_hist = [m for h in port_rec["history"] for m in h]
    assert len(j_hist) == len(t_hist) == 3
    for i, (jm, tm) in enumerate(zip(j_hist, t_hist)):
        assert sorted(jm) == sorted(tm), i
        assert tm["episodic_return"] == jm["episodic_return"], i
        assert tm["global_step"] == jm["global_step"], i
        for k in jm:
            if k != "SPS":
                np.testing.assert_allclose(tm[k], jm[k], rtol=METRIC_RTOL,
                                           atol=METRIC_NOISE_ATOL, err_msg=f"{i} {k}")


def test_train_curve_artifacts(curves):
    """The saved blobs within ``PARAM_ATOL`` with the same run config; the
    JSON with the script's config line, flags and history keys; the
    hardware it names is the device it ran on; the SVG beside it."""
    tmp, _, _, port_blob = curves
    jax_json = json.loads((tmp / "jax" / "ppo_curve_t.json").read_text())
    port_json = json.loads((tmp / "port" / "ppo_curve_t.json").read_text())
    assert port_json == port_blob
    assert port_json["config"] == jax_json["config"]
    assert port_json["hardware"] == "cpu"
    j_args, t_args = dict(jax_json["args"]), dict(port_json["args"])
    assert j_args.pop("save_params") != t_args.pop("save_params")
    assert t_args == j_args
    assert [sorted(m) for m in port_json["history"]] == [sorted(m) for m in jax_json["history"]]
    assert (tmp / "port" / "ppo_curve_t.svg").stat().st_size > 0

    with open(tmp / "jax.pkl", "rb") as f:
        j_blob = pickle.load(f)
    with open(tmp / "port.pkl", "rb") as f:
        t_blob = pickle.load(f)
    assert sorted(t_blob) == sorted(j_blob)
    for k in interop.BLOB_CONFIG_KEYS:
        assert t_blob[k] == j_blob[k], k
    assert max_gap(t_blob["params"], jax.device_get(dict(j_blob["params"]))) <= PARAM_ATOL


def eval_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_eval_policy_on_the_jax_blob_matches_the_script(curves):
    """The JAX-written blob in the port and in ``scripts/eval_policy.py``,
    with ``--probes``: the trained policy's and each probe's JSON numbers
    equal."""
    tmp = curves[0]
    argv = ["--params", str(tmp / "jax.pkl")] + EVAL_ARGV + ["--probes"]
    want = eval_lines(run_script_main(load_script("eval_policy"), argv))
    with contextlib.redirect_stdout(io.StringIO()) as out:
        got = teval.main(argv + ["--device-cpu"])
    assert got == eval_lines(out.getvalue()) == want
    assert [r["policy"] for r in got] == ["trained-greedy", "idle", "random", "greedy-fire"]
    assert len({r["mean_return"] for r in got}) > 1  # the policies differ


def test_eval_policy_on_the_port_blob_in_the_unchanged_script(curves):
    """The port-written blob loads in ``scripts/eval_policy.py`` and gives
    the port's numbers."""
    tmp = curves[0]
    argv = ["--params", str(tmp / "port.pkl")] + EVAL_ARGV
    want = eval_lines(run_script_main(load_script("eval_policy"), argv))
    with contextlib.redirect_stdout(io.StringIO()):
        got = teval.main(argv + ["--device-cpu"])
    assert got == want and len(got) == 1


def test_greedy_and_random_actions_equal_the_script(curves):
    """The trained policy's greedy actions on the same observations (a reset
    and 5 steps of the port's env at 4 envs, handed to both as numpy), and
    the random probe's draws."""
    tmp = curves[0]
    with open(tmp / "jax.pkl", "rb") as f:
        j_blob = pickle.load(f)
    tenv = TEnv(16, 16, key=rng.key(0, device="cpu"), num_envs=4, device="cpu")
    j_act = load_script("eval_policy").greedy_policy_fn(j_blob, tenv)
    t_act = teval.greedy_policy_fn(interop.load_params_blob(tmp / "jax.pkl", "cpu"), tenv)
    obs, info = tenv.reset()
    r = np.random.default_rng(0)
    for step in range(6):
        j_obs = (jnp.asarray(obs[0].numpy()), {
            "position": jnp.asarray(obs[1]["position"].numpy()),
            "per_env_context": {"true_grid": jnp.asarray(
                obs[1]["per_env_context"]["true_grid"].numpy())}})
        np.testing.assert_array_equal(t_act(obs).numpy(), np.asarray(j_act(j_obs)),
                                      err_msg=str(step))
        a = torch.tensor(np.stack([r.integers(0, 9, 4), r.integers(0, 2, 4), np.zeros(4, int)],
                                  -1), dtype=torch.int32)
        obs, _, _, _, info = tenv.stateless_step(a, obs, info)
    random_pol = dict(teval.probe_policies(4, "cpu"))["random"]
    for seed in range(3):
        k = jax.random.key(seed)
        want = np.stack([jax.random.randint(k, (4,), 0, 9),
                         jax.random.randint(jax.random.fold_in(k, 1), (4,), 0, 2),
                         np.zeros(4, np.int32)], axis=1)
        np.testing.assert_array_equal(random_pol(None, rng.key(seed, device="cpu")).numpy(),
                                      want)


def test_load_params_blob_without_flax(curves, monkeypatch):
    """A JAX-written blob (its params are flax FrozenDicts) loads with flax
    blocked from import, to the same arrays; a blob that references any
    other class is refused."""
    tmp = curves[0]
    with open(tmp / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    for name in [m for m in sys.modules if m == "flax" or m.startswith("flax.")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "flax", None)
    with pytest.raises(ImportError):
        import flax  # noqa: F401
    blob = interop.load_params_blob(tmp / "jax.pkl", device="cpu")
    assert {k: blob[k] for k in interop.BLOB_CONFIG_KEYS} == {
        k: want[k] for k in interop.BLOB_CONFIG_KEYS}
    assert max_gap(interop.ppo_params_to_numpy(blob["params"]),
                   {g: {"params": dict(want["params"][g]["params"])}
                    for g in want["params"]}) == 0

    bad = tmp / "bad.pkl"
    bad.write_bytes(pickle.dumps({"params": {}, "hook": Path.cwd}))
    with pytest.raises(pickle.UnpicklingError, match="may not reference"):
        interop.load_params_blob(bad, device="cpu")


def test_save_params_blob_needs_the_whole_config(tmp_path):
    with pytest.raises(ValueError, match="config must hold exactly"):
        interop.save_params_blob(tmp_path / "p.pkl", {}, size=16)
    assert not (tmp_path / "p.pkl").exists()


def test_svg_is_skipped_without_matplotlib(tmp_path, monkeypatch):
    """As on the card's machine: without matplotlib the curve's SVG is
    skipped (``train_curve`` prints a note) and nothing is written."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    steps, rets = np.arange(3), np.asarray([-1.0, -2.0, 0.0])
    assert not tcurve._write_svg(tmp_path / "c.svg", "t", steps, rets, rets != 0)
    assert not (tmp_path / "c.svg").exists()
