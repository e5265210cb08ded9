"""S1 on the card: how K1's per-env counts leave the kernel.

    python3 -m gymca_torch.probes.exp_counts_out

Counterpart of ``scripts/exp_counts_out.py`` at its sizes: 4096 envs over a
(4096, 256, 256) int8 grid that no launch touches, 32 blocks of 128 envs,
1000 launches per repetition, 3 repetitions.  Variants: one int32 count per env
written from registers (``build_w1``), and four per env staged in shared
memory and written by one bulk copy per block (``build_dma``'s SMEM scratch
and DMA; the TPU double-buffered across programs, the card's blocks run
side by side).  The kernel is ``gymca_torch/csrc/probe_floor.cu``.
"""

from __future__ import annotations

from gymca_torch.probes import floor_kernel
from gymca_torch.probes.floor_kernel import FloorVariant

N, STEPS, P = 4096, 1000, 32
B = N // P
VARIANTS = [
    FloorVariant("W1 width-1 counts out", N, B, 0, 1),
    FloorVariant("DMA staged bulk copy, width 4", N, B, 0, 4, staged=True),
]


def run(device=None, steps=STEPS, reps=3):
    return floor_kernel.run_variants(VARIANTS, steps, device, reps)


def main(argv=None):
    floor_kernel.main(VARIANTS, STEPS, argv, __doc__.splitlines()[0])


if __name__ == "__main__":
    main()
