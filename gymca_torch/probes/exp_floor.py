"""S5 on the card: K1's per-step floor by parameter table and output shape.

    python3 -m gymca_torch.probes.exp_floor

Counterpart of ``scripts/exp_floor.py`` at its sizes: 4096 envs over a
(4096, 256, 256) int8 grid that no launch touches, 1000 launches per
repetition, 3 repetitions.  Variants A-G: nothing read or written; a 1-wide
table (the script's stand-in for "bounds only"); 16- and 8-wide tables;
the 16-wide table with 16 and 64 blocks instead of 32; and the 16- and
8-wide tables with 4 counts per env written.  Where a table is 8 or 16 wide
the counts are ``[p[e, 4], p[e, 5], 0, 0]`` of it (the TPU body wrote a 1
into each program's first slot; see ``floor_kernel``).  The kernel is
``gymca_torch/csrc/probe_floor.cu``.
"""

from __future__ import annotations

from gymca_torch.probes import floor_kernel
from gymca_torch.probes.floor_kernel import FloorVariant

N, STEPS = 4096, 1000
VARIANTS = [
    FloorVariant("A empty, P=32", N, N // 32, 0, 0),
    FloorVariant("B table w1, P=32", N, N // 32, 1, 0),
    FloorVariant("C +table w16, P=32", N, N // 32, 16, 0),
    FloorVariant("D +table w8, P=32", N, N // 32, 8, 0),
    FloorVariant("E1 table w16, P=16", N, N // 16, 16, 0),
    FloorVariant("E2 table w16, P=64", N, N // 64, 16, 0),
    FloorVariant("F full shapes (w16+counts) P=32", N, N // 32, 16, 4),
    FloorVariant("G full shapes (w8+counts) P=32", N, N // 32, 8, 4),
]


def run(device=None, steps=STEPS, reps=3):
    return floor_kernel.run_variants(VARIANTS, steps, device, reps)


def main(argv=None):
    floor_kernel.main(VARIANTS, STEPS, argv, __doc__.splitlines()[0])


if __name__ == "__main__":
    main()
