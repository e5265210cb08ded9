"""S3 on the card: K1's fixed overhead against envs per block.

    python3 -m gymca_torch.probes.exp_kernel_overhead

Counterpart of ``scripts/exp_kernel_overhead.py`` at its sizes: 4096 envs
over a (4096, 256, 256) int8 grid that no launch touches, 120 launches per
repetition, 3 repetitions; each env's counts are ``[p[e, 4], p[e, 5], 0, 0]``
of its parameter row.  ``make_noop``: blocks of 32 and 128 envs, two 8-wide
parameter blocks per env (a 16-wide row here, of which the first 8 hold
the params); ``make_noop_fori``: blocks of 512 and 4096 envs, one 8-wide
row.  The kernel is ``gymca_torch/csrc/probe_floor.cu``.
"""

from __future__ import annotations

from gymca_torch.probes import floor_kernel
from gymca_torch.probes.floor_kernel import FloorVariant

N, STEPS = 4096, 120
VARIANTS = [
    FloorVariant("noop B=32, 2 param blocks", N, 32, 16, 4),
    FloorVariant("noop B=128, 2 param blocks", N, 128, 16, 4),
    FloorVariant("noop B=512, 1 param block", N, 512, 8, 4),
    FloorVariant("noop B=4096, 1 param block", N, 4096, 8, 4),
]


def run(device=None, steps=STEPS, reps=3):
    return floor_kernel.run_variants(VARIANTS, steps, device, reps)


def main(argv=None):
    floor_kernel.main(VARIANTS, STEPS, argv, __doc__.splitlines()[0])


if __name__ == "__main__":
    main()
