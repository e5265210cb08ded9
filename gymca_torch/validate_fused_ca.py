"""Distributional validation of the fused Alexandridis CA:
``scripts/validate_fused_ca_tpu.py`` on the port.

    python3 -m gymca_torch.validate_fused_ca [SIZE] [N_ENVS] [STEPS]     # 256 64 500
    python3 -m gymca_torch.validate_fused_ca 64 16 300 --device-cpu

The fused path (kernel K2) draws its per-cell uniforms from threefry2x32 of
(env seed, cell) inside the kernel; the XLA-path counterpart
(``AlexandridisCA``) draws them from the JAX package's key chain.  The two
differ by design, so the claim is distributional: the script's protocol,
exactly.  The same initial population (``key(0)``, ``N_ENVS`` envs at
``SIZE``²) steps through both paths, agents standing still (move 4, no
shot), each step ``stateless_step`` then ``conditional_reset``; every env's
fire and empty cells are counted after each step.  At t = 100, 200, 300,
400 and 500 (those within ``STEPS``) the mean fire count and the mean empty
("burned") count of the two paths must differ by no more than a 4-sigma
band of the cross-env noise, ``4 * hypot(std_x, std_p) / sqrt(N)`` with
numpy's ``std``, or by 5% of the larger mean (at least 1).  PASS/FAIL lines,
``OVERALL: PASS`` and exit code 0, or ``OVERALL: FAIL`` and 1.

Runs on the card; ``--device-cpu`` runs on the CPU.  The script refuses the
CPU (exit 2) because its interpreted kernel's draws are a zero stub; here
the kernel's plain version draws the same threefry bits as the kernel, so a
CPU run is a real check of the fused path's statistics, at a size the CPU
can afford.  ``tests/test_torch_gpu.py::
test_fused_ca_statistics_match_the_xla_path_on_the_card`` is stricter (no
5% floor, burned cells and fire age, t = 100-300) and stays beside it.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from gymca_torch import rng
from gymca_torch.config import resolve_device

__all__ = ["parse_args", "checkpoints", "rollout_fire_stats", "verdict", "main"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Distributional validation of the fused CA")
    ap.add_argument("size", type=int, nargs="?", default=256)
    ap.add_argument("envs", type=int, nargs="?", default=64)
    ap.add_argument("steps", type=int, nargs="?", default=500)
    ap.add_argument("--device-cpu", action="store_true", help="run on the CPU")
    return ap.parse_args(argv)


def checkpoints(steps: int):
    return tuple(t for t in (100, 200, 300, 400, 500) if t <= steps)


def rollout_fire_stats(use_fused_ca: bool, size: int, envs: int, steps: int, device):
    """Fire and empty cells of every env after each step on one CA path:
    two (steps, envs) numpy arrays."""
    from gymca_torch.envs.advanced import AdvancedForestFireBulldozerEnv

    env = AdvancedForestFireBulldozerEnv(size, size, key=rng.key(0, device=device),
                                         num_envs=envs, use_fused_ca=use_fused_ca,
                                         device=device)
    if env.use_fused_ca != use_fused_ca:
        raise RuntimeError("the env did not take the CA path asked for")
    obs, info = env.reset()
    acts = torch.zeros((envs, 3), dtype=torch.int32, device=env.device)
    acts[:, 0] = 4  # stay
    fires, empties = [], []
    for _ in range(steps):
        obs, _, _, _, info = env.conditional_reset(env.stateless_step(acts, obs, info), acts)
        grid = obs[1]["per_env_context"]["true_grid"]
        fires.append((grid == 2).sum(dim=(1, 2)))
        empties.append((grid == 0).sum(dim=(1, 2)))
    return torch.stack(fires).cpu().numpy(), torch.stack(empties).cpu().numpy()


def verdict(f_x, e_x, f_p, e_p, envs: int, steps: int):
    """The script's comparison of the XLA-path (``_x``) and fused (``_p``)
    counts: the lines it prints and whether every check passed."""
    ok, lines = True, []
    for t in checkpoints(steps):
        mx, mp = f_x[t - 1].mean(), f_p[t - 1].mean()
        sx = f_x[t - 1].std() / np.sqrt(envs)
        sp = f_p[t - 1].std() / np.sqrt(envs)
        band = 4.0 * float(np.hypot(sx, sp))
        diff = abs(float(mx - mp))
        v = "PASS" if diff <= max(band, 0.05 * max(mx, mp, 1.0)) else "FAIL"
        ok &= v == "PASS"
        lines.append(f"  t={t:4d}: fire mean xla={mx:9.1f} pallas={mp:9.1f} "
                     f"|diff|={diff:7.1f} band={band:7.1f} -> {v}")
        bx, bp = e_x[t - 1].mean(), e_p[t - 1].mean()
        sbx = e_x[t - 1].std() / np.sqrt(envs)
        sbp = e_p[t - 1].std() / np.sqrt(envs)
        bandb = 4.0 * float(np.hypot(sbx, sbp))
        diffb = abs(float(bx - bp))
        vb = "PASS" if diffb <= max(bandb, 0.05 * max(bx, bp, 1.0)) else "FAIL"
        ok &= vb == "PASS"
        lines.append(f"          burned mean xla={bx:9.1f} pallas={bp:9.1f} "
                     f"|diff|={diffb:7.1f} band={bandb:7.1f} -> {vb}")
    return lines, ok


def main(argv=None) -> int:
    """Both paths, the script's lines; returns the exit code (0 PASS, 1
    FAIL)."""
    a = parse_args(argv)
    dev = resolve_device("cpu" if a.device_cpu else None)
    f_x, e_x = rollout_fire_stats(False, a.size, a.envs, a.steps, dev)
    f_p, e_p = rollout_fire_stats(True, a.size, a.envs, a.steps, dev)
    backend = (f"cuda ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
               else "cpu (the kernel's plain version)")
    print(f"fused-CA distributional validation: {a.envs} envs, {a.size}^2, "
          f"{a.steps} steps, backend={backend}")
    lines, ok = verdict(f_x, e_x, f_p, e_p, a.envs, a.steps)
    for line in lines:
        print(line)
    print("OVERALL:", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
