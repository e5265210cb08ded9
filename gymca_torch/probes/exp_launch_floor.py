"""S2 on the card: the launch floor of a no-op kernel.

    python3 -m gymca_torch.probes.exp_launch_floor

Counterpart of ``scripts/exp_launch_floor.py`` at its sizes: 120 launches
per repetition, 3 repetitions, of a kernel whose blocks of 128 envs read each
env's 16-int32 packed row and write its 4 counts, over a 512-env and a
4096-env (N, 256, 256) int8 grid that no launch touches (``run_launch``,
``make_run_launch``), and over 4096 envs with no grid (``run_smem_only``).
``run_partition``, the XLA class partition of K1's wrapper, has no
counterpart: the port does not partition (K1 launches one block per env
and idle blocks exit).  The kernel is ``gymca_torch/csrc/probe_floor.cu``.
"""

from __future__ import annotations

from gymca_torch.probes import floor_kernel
from gymca_torch.probes.floor_kernel import FloorVariant

N, STEPS, B = 4096, 120, 128
VARIANTS = [
    FloorVariant("launch floor n=512", 512, B, 16, 4),
    FloorVariant("launch floor n=4096", N, B, 16, 4),
    FloorVariant("launch floor no grid", N, B, 16, 4, grid=False),
]


def run(device=None, steps=STEPS, reps=3):
    return floor_kernel.run_variants(VARIANTS, steps, device, reps)


def main(argv=None):
    floor_kernel.main(VARIANTS, STEPS, argv, __doc__.splitlines()[0])


if __name__ == "__main__":
    main()
