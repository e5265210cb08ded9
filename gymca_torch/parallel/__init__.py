"""Parallel paths of the port on ``torch.distributed`` (counterpart of
``gymca_tpu/parallel/``): meshes and process groups (``mesh``), data-parallel
PPO (``sharded``), grids in row bands with halo exchange (``spatial``) and
whole env steps on them (``spatial_env``).  One process per device: NCCL on
CUDA devices, gloo on the CPU."""
