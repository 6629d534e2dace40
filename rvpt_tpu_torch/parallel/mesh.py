"""The ``(tiles, spp)`` device mesh (mirror of ``rvpt_tpu/parallel/mesh.py``).

Film tiles are data parallel over ``tiles`` (the scene is replicated, so
tracing needs no traffic between devices); ``spp`` splits the Monte-Carlo
samples of the same pixels and averages them (the path tracer's analog of
sequence parallelism).  Tensor, pipeline and expert parallelism have no
counterpart in a path tracer.  Ranks are laid out row-major, ``rank = tile
* n_spp + spp``.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from ..core.device import resolve_device
from .distributed import init_group

TILE_AXIS = "tiles"  # data-parallel film tiles
SPP_AXIS = "spp"  # sample-parallel Monte-Carlo axis


def make_mesh(n_tiles: int | None = None, n_spp: int = 1, device=None) -> DeviceMesh:
    """``(tiles, spp)`` mesh over the process group's ranks; ``n_tiles``
    None puts every rank not on ``spp`` on the tile axis.  ``device`` None
    is the card.  With no process group this process is the world: a group
    of one is created on its own store (no environment variables)."""
    device = resolve_device(device)
    if not dist.is_initialized():
        init_group(device, store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n_tiles is None:
        n_tiles = world // n_spp
    if n_tiles * n_spp != world:
        raise ValueError(f"mesh {n_tiles}x{n_spp} != {world} ranks")
    return init_device_mesh(device.type, (n_tiles, n_spp),
                            mesh_dim_names=(TILE_AXIS, SPP_AXIS))


def replicated(mesh: DeviceMesh) -> tuple:
    """DTensor placements of a tensor replicated on every rank."""
    return tuple(Replicate() for _ in range(mesh.ndim))


def row_sharded(mesh: DeviceMesh) -> tuple:
    """DTensor placements of a tensor whose leading (row/tile) axis is
    split over the tile axis and replicated over ``spp``."""
    return (Shard(0),) + tuple(Replicate() for _ in range(mesh.ndim - 1))
