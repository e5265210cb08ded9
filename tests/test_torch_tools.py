"""The validation, the policy ceiling and the two small CLIs of ``scripts/``
on the port, and the packaging of the port, on the CPU at small sizes
(tolerance 0).

``validate_fused_ca``: its fire and empty counts on the XLA-path
counterpart against ``scripts/validate_fused_ca_tpu.py``'s
``rollout_fire_stats``, and its verdict against the script's ``main`` on
the same numpy arrays.  ``exp_policy_ceiling``: the idle, random and
greedy-fire returns and done masks against the script's ``run_policy``.
``update_gallery`` and ``versionate`` write where they are told and nowhere
else.  The scripts are imported by path (``sys.argv`` patched where the
script reads it at import) and read, not edited.
"""

import importlib.util
import io
import sys
import tomllib
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gymca_torch import exp_policy_ceiling, update_gallery, validate_fused_ca, versionate
from gymca_tpu.envs.advanced import AdvancedForestFireBulldozerEnv as JEnv

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def script(name, argv=None, monkeypatch=None):
    """``scripts/<name>.py`` as a module, imported by path with ``sys.argv``
    set to ``argv`` while it is imported."""
    if argv is not None:
        monkeypatch.setattr(sys, "argv", argv)
    path = ROOT / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"script_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- validate_fused_ca --------------------------------------------------------------------


def test_fire_and_empty_counts_equal_the_scripts_on_the_xla_path(monkeypatch):
    """4 envs at 32², 20 steps, agents standing still, each step
    ``stateless_step`` + ``conditional_reset``: every env's fire and empty
    count after every step, bit for bit."""
    mod = script("validate_fused_ca_tpu", ["validate", "32", "4", "20"], monkeypatch)
    want_f, want_e = mod.rollout_fire_stats(use_pallas=False)
    got_f, got_e = validate_fused_ca.rollout_fire_stats(False, 32, 4, 20, "cpu")
    assert got_f.shape == (20, 4)
    np.testing.assert_array_equal(got_f, want_f)
    np.testing.assert_array_equal(got_e, want_e)
    assert got_f[-1].sum() > 0 and (got_f[-1] != got_f[0]).any()


@pytest.mark.parametrize("shift", [0.0, 0.02, 0.5], ids=["same", "inside", "outside"])
def test_verdict_equals_the_scripts(monkeypatch, shift):
    """300 steps of made-up counts for 4 envs (checkpoints t = 100, 200,
    300), the fused path's shifted by a fraction of the mean: the script's
    ``main`` (its rollouts replaced by these arrays, its backend said to be
    a TPU) and the port's ``verdict`` print the same check lines and give
    the same exit code."""
    r = np.random.default_rng(3)
    f_x = r.integers(500, 900, (300, 4))
    e_x = r.integers(3000, 5000, (300, 4))
    f_p = (f_x * (1 + shift)).astype(np.int64) + r.integers(-20, 20, (300, 4))
    e_p = (e_x * (1 + shift)).astype(np.int64)
    mod = script("validate_fused_ca_tpu", ["validate", "64", "4", "300"], monkeypatch)
    monkeypatch.setattr(mod, "rollout_fire_stats",
                        lambda use_pallas: (f_p, e_p) if use_pallas else (f_x, e_x))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(SystemExit) as exit_info:
        mod.main()
    want = buf.getvalue().splitlines()[1:]
    lines, ok = validate_fused_ca.verdict(f_x, e_x, f_p, e_p, 4, 300)
    assert lines + ["OVERALL: " + ("PASS" if ok else "FAIL")] == want
    assert exit_info.value.code == (0 if ok else 1)
    assert ok == (shift < 0.05)


def test_validate_fused_ca_runs_on_the_cpu(capsys):
    """The port's CPU run is a real check (the plain version draws the
    kernel's threefry bits): 8 envs at 32², 100 steps."""
    assert validate_fused_ca.main(["32", "8", "100", "--device-cpu"]) == 0
    out = capsys.readouterr().out
    assert "t= 100: fire mean" in out and out.strip().endswith("OVERALL: PASS")


# --- exp_policy_ceiling -------------------------------------------------------------------


def test_policy_returns_and_done_masks_equal_the_scripts(monkeypatch):
    """4 envs at 32² (the XLA path: the script takes the fused CA only from
    128²), 150 steps: each policy's returns, done mask and summary, bit for
    bit with the script's ``run_policy`` (its arrays caught where it reads
    them back)."""
    mod = script("exp_policy_ceiling")
    caught = []
    real_get = jax.device_get
    monkeypatch.setattr(jax, "device_get", lambda x: caught.append(real_get(x)) or caught[-1])
    done_any = False
    for name in ("idle", "random", "greedy-fire"):
        jenv = JEnv(32, 32, key=jax.random.key(0), num_envs=4, speed_multiplier=1.0,
                    ca_repeat_mode="single", use_pallas_ca=False)
        caught.clear()
        want = mod.run_policy(jenv, name, 150, 4, 1.0)
        want_ret, want_done = caught
        tenv = exp_policy_ceiling.make_env(32, 4, 1.0, "single", "cpu")
        assert not tenv.use_fused_ca
        got, ret, done = exp_policy_ceiling.run_policy(tenv, name, 150, 4)
        np.testing.assert_array_equal(ret.numpy(), np.asarray(want_ret), err_msg=name)
        np.testing.assert_array_equal(done.numpy(), np.asarray(want_done), err_msg=name)
        assert got == want
        done_any |= bool(done.any())
    assert done_any


def test_policy_ceiling_takes_the_fused_ca_as_the_script():
    env = exp_policy_ceiling.make_env(128, 1, 1.0, "single", "cpu")
    assert env.use_fused_ca
    assert not exp_policy_ceiling.make_env(128, 1, 1.0, "modf", "cpu").use_fused_ca
    assert not exp_policy_ceiling.make_env(64, 1, 1.0, "single", "cpu").use_fused_ca


# --- update_gallery and versionate ----------------------------------------------------------


def test_update_gallery_writes_one_render_per_env(tmp_path, capsys):
    written = update_gallery.main(["--out-dir", str(tmp_path / "g"), "--steps", "3",
                                   "--device-cpu"])
    names = sorted(p.name for p in (tmp_path / "g").iterdir())
    assert names == ["ForestFireBulldozer256x256_v3.svg", "ForestFireHelicopter42x42_v1.svg"]
    assert sorted(p.name for p in written) == names
    assert all(p.stat().st_size > 1000 for p in written)
    assert capsys.readouterr().out.count("wrote ") == 2
    assert update_gallery.parse_args([]).out_dir == "pics/torch"


def test_versionate_bumps_a_copy_and_nothing_else(tmp_path, capsys):
    watched = [ROOT / "gymca_tpu" / "version.py", ROOT / "gymca_torch" / "version.py",
               ROOT / "pyproject.toml"]
    before = [p.read_bytes() for p in watched]
    (tmp_path / "gymca_torch").mkdir()
    target = tmp_path / "gymca_torch" / "version.py"
    target.write_text('VERSION = "1.4.9"\n')
    assert versionate.main(["--root", str(tmp_path), "--dry-run", "--major"]) == "2.0.0"
    assert target.read_text() == 'VERSION = "1.4.9"\n'
    assert versionate.main(["--root", str(tmp_path)]) == "1.4.10"
    assert versionate.main(["--root", str(tmp_path), "--minor"]) == "1.5.0"
    assert target.read_text() == 'VERSION = "1.5.0"\n'
    assert versionate.main(["--root", str(tmp_path), "--major"]) == "2.0.0"
    assert "1.5.0 -> 2.0.0" in capsys.readouterr().out
    assert [p.read_bytes() for p in watched] == before
    assert versionate.version_file(versionate.ROOT) == ROOT / "gymca_torch" / "version.py"


# --- packaging ---------------------------------------------------------------------------


def test_every_subpackage_and_kernel_source_is_packaged():
    """An installed copy holds every subpackage of ``gymca_torch`` (each
    directory with an ``__init__.py``) and the kernel sources."""
    config = tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"]["setuptools"]
    pkg = ROOT / "gymca_torch"
    subpackages = {".".join(p.parent.relative_to(ROOT).parts)
                   for p in pkg.rglob("__init__.py")}
    assert {"gymca_torch.agents", "gymca_torch.parallel", "gymca_torch.probes"} <= subpackages
    assert subpackages <= set(config["packages"])
    patterns = config["package-data"]["gymca_torch"]
    packaged = {p for pattern in patterns for p in pkg.glob(pattern)}
    assert set((pkg / "csrc").glob("*.cu")) <= packaged and packaged
