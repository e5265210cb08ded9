"""The metrics' frozen work counts equal the port's own counts on the same
launches, at a small size on the CPU."""

import json

import torch

from benchmark.envs import advanced as adv_env
from benchmark.envs import bulldozer as bull_env
from benchmark.tests import toy
from benchmark.traffic.episodes import Driver

SEED = 2**31 + 55


def _load(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"m_{name}", toy.ROOT / "benchmark/metrics" / f"{name}.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def _cfg(base, **sizes):
    cfg = json.loads((toy.ROOT / "benchmark/configs" / f"{base}.json").read_text())
    cfg.update(sizes)
    return cfg


def _drive(system, n, columns, steps, monkeypatch, module, name):
    """``steps`` steps, each recorded: the state the step starts from (what
    the metric reads) and the kernel's arguments (what the port counts)."""
    real, calls = getattr(module, name), []

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    traffic = {"envs": n, "episode_steps": 200, "actions": columns, "trace_steps": 0}
    loop = Driver(system, traffic, SEED, "cpu", False)
    loop._restart()
    traced = []
    for _ in range(steps):
        loop._step(traced)
    assert len(calls) == steps
    return traced, calls


def test_k1_count_equals_the_port(monkeypatch):
    import gymca_torch.envs.bulldozer as program
    from gymca_torch.probes.kernel_inputs import k1_work

    cfg = _cfg("bulldozer256", nrows=64, ncols=64)
    system = bull_env.System(cfg, 16, SEED, "cpu")
    traced, calls = _drive(system, 16, [[0, 9], [0, 2]], 60, monkeypatch, program,
                           "windy_fused_step")
    metric = _load("k1_roofline")
    edits = 0
    for (x, actions), (args, _) in zip(traced, calls):
        grid, _, params, log, counts = args
        port = k1_work(grid, params, counts, log.shape[1])
        assert metric.work(cfg, x, actions) == (port[0], port[1])
        edits += port[4]
    assert edits > 0  # the deferred edits are on the counted path


def test_k2_count_equals_the_port(monkeypatch):
    import gymca_torch.envs.advanced as program
    from gymca_torch.ops.alexandridis_kernel import alexandridis_work

    cfg = _cfg("advanced256", nrows=32, ncols=32)
    system = adv_env.System(cfg, 4, SEED, "cpu")
    traced, calls = _drive(system, 4, [[0, 9], [0, 2], [0, 1]], 30, monkeypatch, program,
                           "alexandridis_fused_step")
    metric = _load("k2_roofline")
    for (x, _), (args, kw) in zip(traced, calls):
        port = alexandridis_work({"grid": args[0]}, kw)
        assert torch.equal(x["grid"], args[0])
        assert metric.work(cfg, x["grid"]) == (port["bytes"], port["int_ops"],
                                               port["float_ops"])
