"""The port's kernels of a parent tree beside this tree's, on one card.

    python3 -m gymca_torch.probes.ab_parent --parent DIR [--repeats 10] [--sets S4 S3]

``DIR`` is the root of a parent tree that holds its ``gymca_torch`` package
(for example ``git archive <commit> gymca_torch | tar -x -C DIR``).  The
parent's kernel wrappers, ``alexandridis_fused_step``, ``windy_fused_step``,
``ca_variant_step`` and ``probe_floor``, are imported from there beside
this tree's (:func:`tree_wrappers`), so each tree's kernel is built by that
tree's own build module, with its own flags, into its own
``gymca_torch/build/``, and is called through that tree's own wrapper:
nothing here depends on a kernel's C entry point, only on the wrappers'
signatures, which are the port's contract.  Each input set is timed in
turns, parent, this tree, this tree, parent, each turn
``timing.time_launches`` over ``--repeats`` passes of the set's launches
(every device kernel named like the tree's kernel timed on its own events,
so a tree whose wrapper issues two kernels is timed as the sum of both):

* K2 at 64 x 256² (radius 6): 10 launches recorded on the main path after
  200 random steps; the first 10 launches after a reset (2 burning cells
  per env); the synthetic 10%-fire input of ``kernel_inputs``;
* K3 at 8 x 512² (radius 7): 3 launches recorded after 20 steps; the
  synthetic input;
* K1 at 4096 x 256² int8: 10 launches recorded after 200 random steps;
  every env a CA env; every env idle;
* S4, each formulation: 40 in-place steps at the probe's 256 x 256² and 4
  at K1's all-CA size, 4096 x 256², from ``exp_ca_variants``' draw;
* S3: 12 launches over 4096 envs at each launch configuration of
  ``exp_kernel_overhead`` (32 and 128 envs per block with a 16-wide table,
  512 and 4096 with an 8-wide one; 4 counts each).

``--sets`` keeps the sets of the kernels it names (K1, K2, K3, S4, S3;
every one by default): a set belongs to the kernel its name starts with,
and a builder runs only for the kernels kept.  The inputs are made
and recorded with this tree.  Before timing, each tree's kernel is checked
against this tree's plain version on the set's first launch (tolerance 0).
Prints a JSON line per set and the card's name and power limit.
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
from gymca_torch.probes import ca_variants_kernel as cv
from gymca_torch.probes import exp_ca_variants, exp_kernel_overhead
from gymca_torch.probes import floor_kernel as fk
from gymca_torch.probes import kernel_inputs as ki
from gymca_torch.probes import timing

SEED = 0
ADV_ENVS, ADV_SIZE, ADV_STEPS = 64, 256, 200
K3_ENVS, K3_SIZE, K3_STEPS = 8, 512, 20
K1_ENVS, K1_SIZE, K1_STEPS = 4096, 256, 200
RECORDED = 10
S4_SIZES = ((exp_ca_variants.N, exp_ca_variants.STEPS), (K1_ENVS, 4))  # (envs, steps) at 256²
S3_PASS = 12  # launches a pass (exp_kernel_overhead's 120 a repetition over 10 passes)
# the profiler's name for each kernel's device kernels, in either tree
# (S4's: each formulation's, ``ca_variants_kernel.KERNEL_NAMES``)
KERNEL_NAMES = {"K1": "windy_", "K2": "alexandridis_kernel", "K3": "alexandridis_kernel",
                "S3": "probe_floor_kernel"}


def _package_modules() -> dict:
    return {k: m for k, m in sys.modules.items()
            if k == "gymca_torch" or k.startswith("gymca_torch.")}


def tree_wrappers(root: Path):
    """``{"K1": windy_fused_step, "K2": alexandridis_fused_step, "S4":
    ca_variant_step, "S3": probe_floor}`` (K3 is K2's wrapper) of the
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
        s4 = importlib.import_module("gymca_torch.probes.ca_variants_kernel").ca_variant_step
        s3 = importlib.import_module("gymca_torch.probes.floor_kernel").probe_floor
    finally:
        sys.path.remove(str(root))
        for k in _package_modules():
            del sys.modules[k]
        sys.modules.update(ours)
    return {"K1": k1, "K2": k2, "K3": k2, "S4": s4, "S3": s3}


THIS_TREE = {"K1": wk.windy_fused_step, "K2": ak.alexandridis_fused_step,
             "K3": ak.alexandridis_fused_step, "S4": cv.ca_variant_step, "S3": fk.probe_floor}


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


def s4_sets(gen, device="cuda", sizes=S4_SIZES, size=exp_ca_variants.H):
    """S4's input sets: name -> (variant, grid, weights, steps), each
    formulation at every (envs, steps) of ``sizes`` on ``size``² grids."""
    sets = {}
    for n, steps in sizes:
        grid, weights = exp_ca_variants.make_inputs(n, size, size, SEED, device)
        for v in cv.VARIANTS:
            sets[f"S4 {v} {n} x {size}²"] = (v, grid, weights, steps)
    return sets


def s3_sets(gen, device="cuda", size=K1_SIZE):
    """S3's input sets, ``exp_kernel_overhead``'s launch configurations:
    name -> (grid, table, envs per block), the (N, size, size) grid never
    touched, each table drawn from ``gen``."""
    grid = torch.zeros((exp_kernel_overhead.N, size, size), dtype=torch.int8, device=device)
    return {f"S3 B={v.envs_per_block}": (
        grid, torch.randint(-2**31, 2**31 - 1, (v.n, v.table_w), generator=gen, device=device,
                            dtype=torch.int32), v.envs_per_block)
        for v in exp_kernel_overhead.VARIANTS}


SET_BUILDERS = ((("K2", "K3"), k2_sets), (("K1",), k1_sets), (("S4",), s4_sets),
                (("S3",), s3_sets))
KERNELS = ("K1", "K2", "K3", "S4", "S3")


def s4_err(step, v, grid, weights):
    g_k, c_k = step(v, grid.clone(), weights)
    g_p, c_p = cv.PLAIN[v](grid.clone(), weights)
    return max(int((g_k.int() - g_p.int()).abs().max()), int((c_k - c_p).abs().max()))


def s3_err(step, grid, table, envs_per_block):
    got = step(grid, table, counts_w=4, envs_per_block=envs_per_block)
    want = fk.probe_floor_plain(table.shape[0], table, counts_w=4)
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def _case(name, data, step, repeats):
    """``(run, reset, calls, err)`` of input set ``name`` for one tree's
    wrapper ``step``: ``run()`` makes ``calls`` launches, ``reset()``
    restores the inputs, ``err()`` is the first launch against this tree's
    plain version."""
    kernel = name[:2]
    if kernel == "K1":
        empty, tree, fire = ki.WINDY_CELLS
        start = data[0][0]
        grid = start.clone()

        def run():
            for _ in range(repeats):
                for _, w_, p_, e_, c_ in data:
                    step(grid, w_, p_, e_, c_, empty=empty, tree=tree, fire=fire)

        return run, lambda: grid.copy_(start), repeats * len(data), lambda: k1_err(step, data[0])
    if kernel == "S4":
        v, start, weights, steps = data
        grid = start.clone()

        def run():
            for _ in range(repeats * steps):
                step(v, grid, weights)

        return (run, lambda: grid.copy_(start), repeats * steps,
                lambda: s4_err(step, v, start, weights))
    if kernel == "S3":
        grid, table, b = data

        def run():
            for _ in range(repeats * S3_PASS):
                step(grid, table, counts_w=4, envs_per_block=b)

        return run, None, repeats * S3_PASS, lambda: s3_err(step, grid, table, b)

    def run():
        for _ in range(repeats):
            for x, kw in data:
                step(**x, **kw)

    return run, None, repeats * len(data), lambda: k2_err(step, *data[0])


def time_set(name, data, repeats, trees):
    """Time one input set in turns (parent, this tree, this tree, parent)
    through each tree's wrapper (``trees[label][kernel]``)."""
    kernel = name[:2]
    profiled = cv.KERNEL_NAMES[data[0]] if kernel == "S4" else KERNEL_NAMES[kernel]
    out = {"inputs": name}
    for turn, label in enumerate(("parent", "this", "this", "parent")):
        run, reset, calls, err = _case(name, data, trees[label][kernel], repeats)
        out["launches"] = calls
        if turn < 2:
            e = err()
            out[f"{label}_max_abs_err"] = e
            if e != 0:
                raise SystemExit(f"ab_parent: the {label} tree's kernel disagrees with "
                                 f"the plain version on {name}")
        t = timing.time_launches(run, calls, profiled, reset=reset)
        out.setdefault(f"{label}_us", []).append(t["device_us"])
        out[f"{label}_kernels"] = sorted(t["kernels"])
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="root of a parent tree holding its gymca_torch package")
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--sets", nargs="+", choices=KERNELS, default=KERNELS,
                    help="the kernels whose input sets are timed")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ab_parent times kernels on the card and has no CPU path")
    trees = {"parent": tree_wrappers(a.parent), "this": THIS_TREE}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    card = timing.card()
    print(f"[ab] {card}; parent wrappers from "
          f"{Path(trees['parent']['K1'].__globals__['__file__']).parents[2]}",
          file=sys.stderr, flush=True)
    for kernels, builder in SET_BUILDERS:
        if set(kernels).isdisjoint(a.sets):
            continue
        for name, data in builder(gen).items():
            if name[:2] in a.sets:
                time_set(name, data, a.repeats, trees)
    print(card)


if __name__ == "__main__":
    main()
