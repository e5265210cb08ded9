"""The port stands alone: no JAX, no gymca_tpu, no flax, optax or orbax
anywhere in ``gymca_torch/`` (its probes and trainer included) or in
``tests/test_torch_gpu.py``, the card-side checks, and gymnasium only in
the gymnasium adapter modules (``gym_env.py``, loaded on demand, and
``registration.py``, which
registers the ids only where gymnasium can be imported) and in
``update_gallery.py``, whose ``gym.make`` of every id is the script's
(imported when it runs).  ``import
gymca_torch`` and the cores work where gymnasium and matplotlib are
missing, as on the card's machine.

This process already imported jax at start-up, so ``sys.modules`` cannot
show what the port imports: every source is parsed with ``ast`` instead.
"""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_SOURCES = (sorted((ROOT / "gymca_torch").rglob("*.py"))
                + [ROOT / "tests" / "test_torch_gpu.py"])
FORBIDDEN = ("jax", "jaxlib", "gymca_tpu", "flax", "optax", "orbax")
GYM_ADAPTERS = {ROOT / "gymca_torch" / "gym_env.py", ROOT / "gymca_torch" / "registration.py",
                ROOT / "gymca_torch" / "update_gallery.py"}
PROBES = ("timing", "ca_variants_kernel", "dma_floor_kernel", "floor_kernel",
          "exp_ca_variants", "bench_fused_ca", "exp_counts_out", "exp_launch_floor",
          "exp_kernel_overhead", "exp_floor", "sass")
AGENTS = ("args", "networks", "optim", "ppo", "checkpoint")
# The public surface, Helicopter and the utilities (ROADMAP §1 items 5-6).
SURFACE = ("ops/drossel", "envs/helicopter", "registration", "version", "compat",
           "utils/__init__", "utils/neighbors", "utils/render", "utils/metrics")
# The legacy sequential spec and the curve and policy-evaluation entry points
# (ROADMAP §1 items 8 and 10).
SLICE_8 = ("ops/alexandridis_legacy", "train_curve", "eval_policy")
# parallel/ on torch.distributed and the scaling harness (ROADMAP §1 item 9).
PARALLEL = ("parallel/__init__", "parallel/mesh", "parallel/sharded", "parallel/spatial",
            "parallel/spatial_env", "bench_scaling")
# The profiling, validation and tool entry points of scripts/ (ROADMAP §1
# item 2 and the step breakdowns).
TOOLS = ("profile_step", "probes/exp_split", "bench_advanced", "profile_advanced",
         "exp_advanced_split", "validate_fused_ca", "exp_policy_ceiling", "update_gallery",
         "versionate", "probes/kernel_inputs")
# bench.py as ``python3 -m gymca_torch.bench``.
BENCH = ("bench",)


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_sources_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_SOURCES}
    assert "gymca_torch/envs/bulldozer.py" in names
    assert "gymca_torch/ops/windy_kernel.py" in names
    assert "gymca_torch/ops/alexandridis_kernel.py" in names
    assert "gymca_torch/envs/advanced.py" in names
    assert "tests/test_torch_gpu.py" in names
    for mod in AGENTS:
        assert f"gymca_torch/agents/{mod}.py" in names
    assert "gymca_torch/run.py" in names
    for probe in PROBES:
        assert f"gymca_torch/probes/{probe}.py" in names
    for mod in SURFACE + SLICE_8 + PARALLEL + TOOLS + BENCH:
        assert f"gymca_torch/{mod}.py" in names


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_reference_imports(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"
        if top == "gymnasium":
            assert path in GYM_ADAPTERS, f"{path.name} imports gymnasium"


def test_ast_scan_catches_forbidden_imports(tmp_path):
    src = tmp_path / "bad.py"
    src.write_text("import os\nfrom jax import numpy\n"
                   "def f():\n    import gymca_tpu.ops\n")
    assert {"jax", "gymca_tpu.ops"} <= set(imported_modules(src))


@pytest.mark.parametrize("module", [
    "gymca_torch.config", "gymca_torch.rng", "gymca_torch.core.spaces",
    "gymca_torch.core.operator", "gymca_torch.core.env", "gymca_torch.ops.stencil",
    "gymca_torch.ops.windy", "gymca_torch.ops.move_modify", "gymca_torch.ops.repeat_ca",
    "gymca_torch.ops.windy_kernel", "gymca_torch.envs.bulldozer", "gymca_torch.interop",
    "gymca_torch._build", "gymca_torch.gym_env", "gymca_torch.ops.alexandridis",
    "gymca_torch.ops.alexandridis_kernel", "gymca_torch.envs.terrain",
    "gymca_torch.envs.extensions", "gymca_torch.envs.advanced", "gymca_torch.probes",
    *(f"gymca_torch.probes.{p}" for p in PROBES),
    "gymca_torch.agents", *(f"gymca_torch.agents.{m}" for m in AGENTS), "gymca_torch.run",
    *("gymca_torch." + m.replace("/__init__", "").replace("/", ".") for m in SURFACE),
    *("gymca_torch." + m.replace("/", ".") for m in SLICE_8),
    *("gymca_torch." + m.replace("/__init__", "").replace("/", ".") for m in PARALLEL),
    *("gymca_torch." + m.replace("/", ".") for m in TOOLS),
    *("gymca_torch." + m for m in BENCH),
])
def test_modules_import_without_a_card(module):
    importlib.import_module(module)


def test_gym_adapters_load_on_demand():
    from gymca_torch.core import env
    from gymca_torch.envs import bulldozer
    from gymca_torch.gym_env import ForestFireBulldozerEnv, GymCAEnv

    assert env.GymCAEnv is GymCAEnv
    assert bulldozer.ForestFireBulldozerEnv is ForestFireBulldozerEnv
    with pytest.raises(AttributeError):
        env.NoSuchThing  # noqa: B018


def test_advanced_env_asks_for_the_card_by_default():
    """Without ``device=`` the Advanced env runs on the card, and raises
    where there is none."""
    import torch

    from gymca_torch import rng
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdvancedForestFireBulldozerEnv(16, 16, key=rng.key(0, device="cpu"), num_envs=1)


def test_package_works_without_gymnasium_and_matplotlib():
    """As on the card's machine: with gymnasium and matplotlib unimportable,
    ``import gymca_torch`` registers nothing and the Helicopter core, the
    renders' module and the entry point still import and run; the gym
    surface raises ImportError only when asked for."""
    import subprocess
    import sys

    script = """
import sys
for name in ("gymnasium", "matplotlib"):
    sys.modules[name] = None
import torch
import gymca_torch
from gymca_torch import rng
from gymca_torch.core.env import autoreset_step
from gymca_torch.envs.helicopter import HelicopterCore
import gymca_torch.utils.render, gymca_torch.utils.metrics, gymca_torch.run
core = HelicopterCore(8, 8, device="cpu")
state = core.initial_state(rng.split(rng.key(0, device="cpu"), 3))
state, out = autoreset_step(core, state, torch.tensor([0, 4, 8]))
assert out.reward.shape == (3,) and gymca_torch.__version__
try:
    gymca_torch.GridSpace
except ImportError:
    print("ok")
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
