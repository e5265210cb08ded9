"""Port-side probes: the TPU probe scripts of ``scripts/`` on the card.

Each probe is a hand-written CUDA kernel (``gymca_torch/csrc/``), a wrapper
with a launch counter and a plain PyTorch version, and an entry point named
after the script it stands for::

    python3 -m gymca_torch.probes.exp_ca_variants      # S4: four windy-CA formulations
    python3 -m gymca_torch.probes.bench_fused_ca       # S6: the Alexandridis kernel,
    python3 -m gymca_torch.probes.bench_fused_ca --tiled  #   its ablations, its streaming floor
    python3 -m gymca_torch.probes.exp_counts_out       # S1: count output layouts
    python3 -m gymca_torch.probes.exp_launch_floor     # S2: the launch floor
    python3 -m gymca_torch.probes.exp_kernel_overhead  # S3: envs per block
    python3 -m gymca_torch.probes.exp_floor            # S5: table and output shapes

``python3 -m gymca_torch.probes.exp_split`` drives K1 itself
(``gymca_torch/csrc/windy_sparse.cu``, no probe kernel of its own) with the
work lists of ``scripts/exp_split.py``, to attribute its time by class.

``python3 -m gymca_torch.probes.ab_parent --parent DIR`` times a parent
tree's K1 and K2, through that tree's own wrappers, beside this tree's, in
turns on one card, on the
input sets of :mod:`~gymca_torch.probes.kernel_inputs` (shared with the
card's checks, ``tests/test_torch_gpu.py``).  :mod:`~gymca_torch.probes.timing` is their shared
timing harness.  The entry
points run on the card and raise without one; their ``run`` functions take
``device="cpu"`` and then run the plain versions and measure nothing.
"""
