"""Runs of toy cells on the CPU: the harness end to end with the card's
look skipped, the reference against the program, the control and the
faults a run must catch, and a cell, traffic mix and metric added as new
files."""

import json

import pytest
import torch

from benchmark import run as bench_run
from benchmark.reference import advanced as A
from benchmark.reference import bulldozer as B
from benchmark.tests import toy

SEED = 2**31 + 4099
CELLS = ("bulldozer-toy", "advanced-toy", "advanced-sparse")
KEYS = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "cold_build",
        "checks")


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return bench_run.Spec(toy.build(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_the_program_equals_the_reference(spec, cell, trace):
    r = bench_run.run_cell(spec, cell, SEED, 0, trace, "cpu", max_steps=55)
    assert r["correct"], r["checks"]
    assert set(r) <= set(KEYS) and list(r)[-1] == "checks"
    assert r["attempted"] == 55 * spec.traffic(spec.cell(cell))["envs"]
    assert all(c["value"] == c["limit"] == 0 for c in r["checks"].values())
    assert r["cold_build"] is False  # nothing is built on the CPU
    names = {m["name"] for m in spec.metrics(spec.cell(cell), trace)}
    assert set(r["metrics"]) <= names
    if not trace:  # on the CPU only the host clock's metrics read
        host = {m["name"] for m in spec.metrics(spec.cell(cell), False)
                if m["source"] == "host_clock"}
        assert "setup_s" in host and set(r["metrics"]) == host


def test_the_sparse_cell_resets_envs():
    """The auto-reset's fresh states are on the compared path."""
    cfg = json.loads((toy.ROOT / "benchmark/configs/advanced256.json").read_text())
    cfg.update(toy.TOY["advanced-sparse"][1])
    from benchmark.terrain import make_terrain

    n = 6
    terrain = make_terrain(n, 8, 8, SEED, "cpu")
    acts = _toy_actions(n, 55, [[0, 9], [0, 2], [0, 1]])
    p = A.Params(cfg, "cpu")
    s, resets = A.initial(p, SEED, n, terrain, "cpu"), 0
    for a in acts:
        s = A.step(p, s, a)
        resets += int(s["terminated"].sum())
    assert resets > 0


def _toy_actions(n, steps, columns, seed=5):
    g = torch.Generator().manual_seed(seed)
    return torch.stack([torch.randint(lo, hi, (steps, n), generator=g) for lo, hi in columns],
                       -1).int()


def test_the_control_fails_the_bulldozer_check():
    """The reference in bfloat16 in the program's place reads not correct."""
    cfg = json.loads((toy.ROOT / "benchmark/configs/bulldozer256.json").read_text())
    cfg.update(nrows=64, ncols=64)
    idx = torch.arange(8)
    acts = _toy_actions(8, 120, [[0, 9], [0, 2]])
    start, end = B.replay(cfg, SEED, 8, idx, acts, "cpu")
    low_start, low_end = B.replay(cfg, SEED, 8, idx, acts, "cpu", low=True)
    numbers = B.check(low_start, start, low_end, end)
    assert any(v > B.LIMITS[k] for k, v in numbers.items()), numbers


def test_the_control_fails_the_advanced_check():
    from benchmark.terrain import make_terrain

    cfg = json.loads((toy.ROOT / "benchmark/configs/advanced256.json").read_text())
    cfg.update(nrows=32, ncols=32)
    terrain = make_terrain(4, 32, 32, SEED, "cpu")
    idx = torch.arange(4)
    acts = _toy_actions(4, 60, [[0, 9], [0, 2], [0, 1]])
    start, end = A.replay(cfg, SEED, 4, idx, acts, "cpu", terrain)
    low_start, low_end = A.replay(cfg, SEED, 4, idx, acts, "cpu", terrain, low=True)
    numbers = A.check(low_start, start, low_end, end)
    assert any(v > A.LIMITS[k] for k, v in numbers.items()), numbers


# --- the timed path broken underneath: each fault must read not correct ---


def _bulldozer_fault(kind):
    from gymca_torch.envs.bulldozer import BulldozerCore

    real = BulldozerCore.step_batched

    def step(self, states, actions):
        if kind == "unchanged":
            return states, None
        before = states.clone()  # the step writes grids in place
        new, out = real(self, states, actions)
        if kind == "half":  # the second half of the batch left out
            h = new.grid.shape[0] // 2
            new.grid[h:] = before.grid[h:]
            new.key[h:] = before.key[h:]
            new.reward_accumulated[h:] = before.reward_accumulated[h:]
            for k, v in new.context.items():
                v[h:] = before.context[k][h:]
        else:  # an answer altered where it is produced
            new.reward_accumulated[-1] += 1e-3
        return new, out

    return BulldozerCore, "step_batched", step


def _advanced_fault(kind):
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv as Env

    real = Env.stateless_step

    def step(self, action, obs, info):
        if kind == "unchanged":
            return obs, info["reward"], info["terminated"], info["terminated"], info
        out = real(self, action, obs, info)
        (rgb, context), reward, done, trunc, new_info = out
        if kind == "half":
            h = rgb.shape[0] // 2
            rgb[h:] = obs[0][h:]
            for k, v in context["per_env_context"].items():
                if v.dim() and v.shape[0] == rgb.shape[0]:
                    v = v.clone()
                    v[h:] = obs[1]["per_env_context"][k][h:]
                    context["per_env_context"][k] = v
        else:
            rgb = rgb.clone()
            rgb[0, 0, 0, 0] ^= 1
        return (rgb, context), reward, done, trunc, new_info

    return Env, "stateless_step", step


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell,fault", [("bulldozer-toy", _bulldozer_fault),
                                        ("advanced-toy", _advanced_fault)])
def test_a_broken_step_reads_not_correct(spec, monkeypatch, cell, fault, kind):
    monkeypatch.setattr(*fault(kind))
    r = bench_run.run_cell(spec, cell, SEED, 0, False, "cpu", max_steps=30)
    assert not r["correct"], r["checks"]


def _reset_fault(kind):
    """The auto-reset's fresh states drawn wrong for the envs it resets."""
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv as Env

    real = Env.conditional_reset

    def reset(self, step_tuple, action):
        (rgb, context), reward, cleared, trunc, info = real(self, step_tuple, action)
        done = step_tuple[2]
        per_env = dict(context["per_env_context"])
        if kind == "key":  # another fold_in of the reset's key
            per_env["key"] = torch.where(done[:, None], per_env["key"] ^ 1, per_env["key"])
        else:  # the dousing marks kept
            kept = step_tuple[0][1]["per_env_context"]["dousing_count"]
            per_env["dousing_count"] = torch.where(done[:, None, None], kept,
                                                   per_env["dousing_count"])
        context = dict(context, per_env_context=per_env)
        return (rgb, context), reward, cleared, trunc, info

    return Env, "conditional_reset", reset


@pytest.mark.parametrize("kind", ["key", "dousing"])
def test_a_wrong_fresh_state_reads_not_correct(spec, monkeypatch, kind):
    """No env of the Advanced cell resets by itself within its episode; the
    check's forced reset still catches the reset's faults."""
    monkeypatch.setattr(*_reset_fault(kind))
    r = bench_run.run_cell(spec, "advanced-toy", SEED, 0, False, "cpu", max_steps=30)
    assert not r["correct"] and r["checks"]["reset_values_wrong"]["value"] > 0, r["checks"]


# --- the harness's data: new cells, traffic and metrics are new files ---


def test_a_metric_added_as_a_file_is_reported(tmp_path):
    root = toy.build(tmp_path)
    (root / "benchmark/metrics/toy_steps.py").write_text(
        "def read(run):\n    return run['steps']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "toy_steps", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "step_ms_p95", "workloads": ["bulldozer-toy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = bench_run.run_cell(bench_run.Spec(root), "bulldozer-toy", SEED, 0, True, "cpu",
                           max_steps=12)
    assert r["metrics"]["toy_steps"] == {"value": 12.0, "unit": "steps"}


def test_a_traffic_kind_added_as_a_file_drives_its_cell(tmp_path):
    """A new kind of traffic is a new driver file beside the mixes."""
    root = toy.build(tmp_path)
    (root / "benchmark/traffic/fixed.py").write_text(
        "import torch\n\n"
        "from benchmark.traffic.episodes import Driver as Episodes\n\n\n"
        "class Driver(Episodes):\n"
        "    def _draw(self):\n"
        "        t, n = self.traffic['episode_steps'], self.traffic['envs']\n"
        "        row = torch.tensor(self.traffic['fixed'], dtype=torch.int32)\n"
        "        return row.expand(t, n, len(row)).clone()\n")
    traffic = json.loads((root / "benchmark/traffic/advanced-toy.json").read_text())
    traffic.update(kind="fixed", fixed=[4, 1, 0])
    (root / "benchmark/traffic/fixed-4.json").write_text(json.dumps(traffic))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == "advanced-toy")
    bench["workloads"].append(dict(cell, name="advanced-fixed", traffic="fixed-4"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "advanced-toy" in m.get("workloads", []):
            m["workloads"].append("advanced-fixed")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = bench_run.run_cell(bench_run.Spec(root), "advanced-fixed", SEED, 0, True, "cpu",
                           max_steps=9)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 9 * traffic["envs"]


def test_without_a_card_there_is_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert bench_run.main(["--workload", "bulldozer256-random-4096", "--seed", "1",
                           "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    assert bench_run.forbidden_modules() == []  # gymca_torch is not gymca_tpu
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "gymca_tpu_extra", types.ModuleType("gymca_tpu_extra"))
    assert bench_run.forbidden_modules() == ["jax"]


def test_comparisons_count_every_difference():
    from benchmark.reference.compare import largest_gap, values_wrong

    ref = {"g": torch.tensor([[1, 2], [3, 4]]), "r": torch.tensor([0.5, -1.0])}
    assert values_wrong({"g": torch.tensor([[1, 2], [3, 5]])}, ref, ("g",)) == 1
    assert values_wrong({"g": torch.tensor([1, 2, 3, 4])}, ref, ("g",)) == 4  # shape
    assert largest_gap({"r": torch.tensor([0.5, -1.25])}, ref, ("r",)) == 0.25
    assert largest_gap({"r": torch.tensor([0.5, float("nan")])}, ref, ("r",)) != 0.0
    assert largest_gap({"r": torch.tensor([0.5])}, ref, ("r",)) == float("inf")
