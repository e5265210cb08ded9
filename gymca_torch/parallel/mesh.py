"""Process groups and device meshes for the port's parallel paths.

Counterpart of ``gymca_tpu/parallel/mesh.py`` on ``torch.distributed``: one
process per device, NCCL between CUDA devices and gloo between CPU
processes.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
the JAX package's axis names and shapes, and a mesh axis is the process
group ``mesh.get_group(name)``.

Where the JAX package places a global array on the mesh, the port keeps on
each rank only its block of it: :func:`shard_env_batch` cuts this rank's
slice out of a value every rank computed the same way (a reset from a
shared key), as ``gymca_tpu/parallel/mesh.py:98-103`` asks of its processes.
``data_sharding`` and ``replicated_sharding`` have no torch object to return
(a rank-local tensor is its own placement) and are left out.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gymca_torch.config import resolve_device
from gymca_torch.core.env import tree_map

__all__ = ["initialize_distributed", "is_coordinator", "make_mesh", "make_2d_mesh",
           "make_host_device_mesh", "shard_env_batch", "axis_size", "axis_rank",
           "collective_device"]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device=None) -> None:
    """Bring up the default process group over ``tcp://coordinator_address``.

    ``device`` picks the backend: NCCL for a CUDA device (the default, the
    card), gloo only when the caller names the CPU.  ``num_processes`` and
    ``process_id`` default to torchrun's ``WORLD_SIZE`` and ``RANK``, the
    address to its ``MASTER_ADDR:MASTER_PORT``.  A no-op for one process when
    a group of the device's backend already exists; a group of the other
    backend raises.
    """
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
    if dist.is_initialized():
        want = ("gloo" if device is not None and torch.device(device).type == "cpu"
                else "nccl")
        if dist.get_backend() != want:
            raise RuntimeError(f"a {dist.get_backend()} process group exists; the "
                               f"{'CPU' if want == 'gloo' else 'card'} needs {want}")
        if world == 1 or world == dist.get_world_size():
            return
        raise RuntimeError(f"a process group of {dist.get_world_size()} ranks exists; "
                           f"asked for {world}")
    dev = resolve_device(device)
    if coordinator_address is None:
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
                               f"{os.environ['MASTER_PORT']}")
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0)) if dev.index is None else dev.index
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init, world_size=world, rank=rank,
                                device_id=dev)
    else:
        dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)


def is_coordinator() -> bool:
    """True on the process that owns logging and checkpoint writes (rank 0)."""
    return dist.get_rank() == 0


def collective_device() -> torch.device:
    """The device the default group's collectives take their tensors on:
    this rank's card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _mesh(ranks: torch.Tensor, names: Sequence[str]) -> DeviceMesh:
    return DeviceMesh(collective_device().type, ranks, mesh_dim_names=tuple(names))


def make_mesh(num_devices: Optional[int] = None, axis_name: str = "data",
              ranks: Optional[Sequence[int]] = None) -> DeviceMesh:
    """1-D mesh over the first ``num_devices`` ranks (default: all), or over
    ``ranks``.  Every rank of the world calls it; a rank outside the mesh
    gets a mesh whose ``get_coordinate()`` is None."""
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    if num_devices is not None:
        ranks = ranks[:num_devices]
    return _mesh(torch.tensor(ranks), (axis_name,))


def make_2d_mesh(data: int, space: int, axis_names: tuple = ("data", "space"),
                 ranks: Optional[Sequence[int]] = None) -> DeviceMesh:
    """2-D ``(data, space)`` mesh, data-major: rank ``i * space + j`` sits at
    ``(i, j)``, as ``np.reshape`` orders the JAX package's devices."""
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    assert data * space <= len(ranks), (data, space, len(ranks))
    return _mesh(torch.tensor(ranks[:data * space]).reshape(data, space), axis_names)


def make_host_device_mesh(axis_names: tuple = ("host", "device")) -> DeviceMesh:
    """2-D ``(host, device)`` mesh: the leading axis crosses hosts, the
    trailing one stays on a host.  A host's ranks are torchrun's
    ``LOCAL_WORLD_SIZE`` consecutive ranks; raises unless every host runs the
    same number of them."""
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    mine = torch.tensor([local], dtype=torch.int64, device=collective_device())
    every = [torch.zeros_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    sizes = {int(t) for t in every}
    if len(sizes) != 1 or world % local:
        raise ValueError(f"uneven local device counts across processes: "
                         f"{sorted(int(t) for t in every)} over {world} ranks")
    return _mesh(torch.arange(world).reshape(world // local, local), axis_names)


def axis_size(mesh: DeviceMesh, axis_name: str) -> int:
    """The size of one named axis of ``mesh`` (JAX's ``mesh.shape[name]``)."""
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def axis_rank(mesh: DeviceMesh, axis_name: str) -> int:
    """This rank's coordinate along one named axis (JAX's
    ``lax.axis_index``)."""
    return mesh.get_local_rank(axis_name)


def shard_env_batch(mesh: DeviceMesh, tree, axis_name: str = "data"):
    """This rank's block of every leaf with a leading env axis.

    A leaf whose leading dimension divides by the axis size and is at least
    that size is cut into equal consecutive blocks along it, one per rank of
    the axis, and this rank keeps its own; key data ``(N, 2)`` slices like
    any leaf.  Other leaves (scalars, shared context) are returned as they
    are.  The rule reads shapes only, so pass per-env leaves alone: a shared
    table whose first dimension happens to divide (the 8 winds) would be cut
    too, where the JAX package would only place it.
    """
    n = axis_size(mesh, axis_name)
    idx = axis_rank(mesh, axis_name)

    def place(x):
        if not isinstance(x, torch.Tensor) or x.dim() < 1:
            return x
        if x.shape[0] % n or x.shape[0] < n:
            return x
        per = x.shape[0] // n
        return x[idx * per:(idx + 1) * per]

    return tree_map(place, tree)
