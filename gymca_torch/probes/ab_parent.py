"""The main paths' kernels of a parent tree beside this tree's, on one card.

    python3 -m gymca_torch.probes.ab_parent --parent DIR [--repeats 10]

``DIR`` is the root of a parent tree that holds its ``gymca_torch`` package
(for example ``git archive <commit> gymca_torch | tar -x -C DIR``).  The
parent's two kernel wrappers, ``alexandridis_fused_step`` and
``windy_fused_step``, are imported from there beside this tree's
(:func:`tree_wrappers`), so each tree's kernel is built by that tree's own
build module, with its own flags, into its own ``gymca_torch/build/``, and
is called through that tree's own wrapper: nothing here depends on a
kernel's C entry point, only on the wrappers' signatures, which are the
port's contract.  Each input set is timed in turns, parent, this tree, this
tree, parent, each turn ``timing.time_launches`` over ``--repeats`` passes
of the set's launches (every device kernel named like the tree's kernel
timed on its own events, so a tree whose wrapper issues two kernels is
timed as the sum of both):

* K2 at 64 x 256² (radius 6): 10 launches recorded on the main path after
  200 random steps; the first 10 launches after a reset (2 burning cells
  per env); the synthetic 10%-fire input of ``kernel_inputs``;
* K3 at 8 x 512² (radius 7): 3 launches recorded after 20 steps; the
  synthetic input;
* K1 at 4096 x 256² int8: 10 launches recorded after 200 random steps;
  every env a CA env; every env idle.

The inputs are made and recorded with this tree.  Before timing, each
tree's kernel is checked against this tree's plain version on the set's
first launch (tolerance 0).  Prints a JSON line per set and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import torch

from gymca_torch import rng
from gymca_torch.ops import alexandridis_kernel as ak
from gymca_torch.ops import windy_kernel as wk
from gymca_torch.probes import kernel_inputs as ki
from gymca_torch.probes import timing

SEED = 0
ADV_ENVS, ADV_SIZE, ADV_STEPS = 64, 256, 200
K3_ENVS, K3_SIZE, K3_STEPS = 8, 512, 20
K1_ENVS, K1_SIZE, K1_STEPS = 4096, 256, 200
RECORDED = 10
# the profiler's name for each kernel's device kernels, in either tree
KERNEL_NAMES = {"K1": "windy_", "K2": "alexandridis_kernel", "K3": "alexandridis_kernel"}


def _package_modules() -> dict:
    return {k: m for k, m in sys.modules.items()
            if k == "gymca_torch" or k.startswith("gymca_torch.")}


def tree_wrappers(root: Path):
    """``{"K1": windy_fused_step, "K2": alexandridis_fused_step}`` of the
    ``gymca_torch`` package under ``root``, imported beside this process's
    own: the package's modules are loaded afresh with ``root`` first on the
    path, then this process's modules are put back.  Each function keeps
    the modules it was loaded with (the package imports nothing inside its
    functions)."""
    root = Path(root).resolve()
    if not (root / "gymca_torch" / "__init__.py").is_file():
        raise FileNotFoundError(f"{root} holds no gymca_torch package")
    ours = _package_modules()
    for k in ours:
        del sys.modules[k]
    sys.path.insert(0, str(root))
    try:
        k2 = importlib.import_module("gymca_torch.ops.alexandridis_kernel").alexandridis_fused_step
        k1 = importlib.import_module("gymca_torch.ops.windy_kernel").windy_fused_step
    finally:
        sys.path.remove(str(root))
        for k in _package_modules():
            del sys.modules[k]
        sys.modules.update(ours)
    return {"K1": k1, "K2": k2, "K3": k2}


def k2_sets(gen):
    """K2's input sets: name -> list of (x, kw)."""
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv

    sets = {}
    env = AdvancedForestFireBulldozerEnv(ADV_SIZE, ADV_SIZE, key=rng.key(SEED),
                                         num_envs=ADV_ENVS)
    obs, info = env.reset()
    sets["K2 after reset"] = ki.record_alexandridis_launches(
        env, obs, info, ki.adv_actions(gen, RECORDED, ADV_ENVS))
    obs, info, _ = ki.adv_run(env, obs, info, ki.adv_actions(gen, ADV_STEPS, ADV_ENVS))
    sets["K2 main path"] = ki.record_alexandridis_launches(
        env, obs, info, ki.adv_actions(gen, RECORDED, ADV_ENVS))
    sets["K2 synthetic"] = [ki.alexandridis_inputs(ADV_ENVS, ADV_SIZE, ADV_SIZE, gen)]
    env3 = AdvancedForestFireBulldozerEnv(K3_SIZE, K3_SIZE, key=rng.key(SEED),
                                          num_envs=K3_ENVS)
    obs, info = env3.reset()
    obs, info, _ = ki.adv_run(env3, obs, info, ki.adv_actions(gen, K3_STEPS, K3_ENVS))
    sets["K3 main path"] = ki.record_alexandridis_launches(
        env3, obs, info, ki.adv_actions(gen, 3, K3_ENVS))
    sets["K3 synthetic"] = [ki.alexandridis_inputs(K3_ENVS, K3_SIZE, K3_SIZE, gen)]
    return sets


def k1_sets(gen):
    """K1's input sets: name -> list of (grid, weights, params, edits,
    edit_counts)."""
    from gymca_torch.envs.bulldozer import BulldozerCore

    core = BulldozerCore(K1_SIZE, K1_SIZE)
    states = core.initial_state(rng.split(rng.key(SEED, device="cuda"), K1_ENVS))
    states, _ = ki.run_steps(core, states, ki.draw_actions(gen, K1_STEPS, K1_ENVS))
    k = core._edit_log_k
    return {
        "K1 main path": ki.record_windy_launches(core, states,
                                                 ki.draw_actions(gen, RECORDED, K1_ENVS)),
        "K1 all CA": [ki.windy_inputs(K1_ENVS, K1_SIZE, K1_SIZE, torch.int8, k, gen,
                                      classes="ca")],
        "K1 all idle": [ki.windy_inputs(K1_ENVS, K1_SIZE, K1_SIZE, torch.int8, k, gen,
                                        classes="idle")],
    }


def k2_err(step, x, kw):
    g_k, a_k = step(**x, **kw)
    g_p, a_p = ak.alexandridis_fused_step_plain(**x, **kw)
    return max(int((g_k.int() - g_p.int()).abs().max()), float((a_k - a_p).abs().max()))


def k1_err(step, inputs):
    empty, tree, fire = ki.WINDY_CELLS
    grid, rest = inputs[0], inputs[1:]
    g_k, c_k = step(grid.clone(), *rest, empty=empty, tree=tree, fire=fire)
    g_p, c_p = wk.windy_fused_step_plain(grid.clone(), *rest, empty=empty, tree=tree,
                                         fire=fire)
    return max(int((g_k.int() - g_p.int()).abs().max()), int((c_k - c_p).abs().max()))


def time_set(name, launches, repeats, trees):
    """Time one input set in turns (parent, this tree, this tree, parent)
    through each tree's wrapper (``trees[label][kernel]``)."""
    kernel = name[:2]
    out = {"inputs": name, "launches": repeats * len(launches)}
    for turn, label in enumerate(("parent", "this", "this", "parent")):
        step = trees[label][kernel]
        if kernel == "K1":
            empty, tree, fire = ki.WINDY_CELLS
            start = launches[0][0]
            grid = start.clone()

            def run():
                for _ in range(repeats):
                    for _, w_, p_, e_, c_ in launches:
                        step(grid, w_, p_, e_, c_, empty=empty, tree=tree, fire=fire)

            def reset():
                grid.copy_(start)
        else:
            def run():
                for _ in range(repeats):
                    for x, kw in launches:
                        step(**x, **kw)
            reset = None
        if turn < 2:
            first = launches[0]
            err = k1_err(step, first) if kernel == "K1" else k2_err(step, *first)
            out[f"{label}_max_abs_err"] = err
            if err != 0:
                raise SystemExit(f"ab_parent: the {label} tree's kernel disagrees with "
                                 f"the plain version on {name}")
        t = timing.time_launches(run, repeats * len(launches), KERNEL_NAMES[kernel],
                                 reset=reset)
        out.setdefault(f"{label}_us", []).append(t["device_us"])
        out[f"{label}_kernels"] = sorted(t["kernels"])
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="root of a parent tree holding its gymca_torch package")
    ap.add_argument("--repeats", type=int, default=10)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ab_parent times kernels on the card and has no CPU path")
    trees = {"parent": tree_wrappers(a.parent),
             "this": {"K1": wk.windy_fused_step, "K2": ak.alexandridis_fused_step,
                      "K3": ak.alexandridis_fused_step}}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    card = timing.card()
    print(f"[ab] {card}; parent wrappers from "
          f"{Path(trees['parent']['K1'].__globals__['__file__']).parents[2]}",
          file=sys.stderr, flush=True)
    for name, launches in {**k2_sets(gen), **k1_sets(gen)}.items():
        time_set(name, launches, a.repeats, trees)
    print(card)


if __name__ == "__main__":
    main()
