"""Process-group set-up and the film's gather to one host (mirror of
``rvpt_tpu/parallel/distributed.py``).

One process per device: call :func:`initialize_distributed` once per
process before the first collective (under ``torchrun`` with no
arguments), build the ``(tiles, spp)`` mesh with ``parallel.mesh.make_mesh``
and render or train with ``parallel.sharded``.  The scene is replicated;
the collectives carry the film's slices, the spp mean and, in training,
the scene gradients.  The package uses three collectives, ``all_reduce``,
``all_gather`` (list form) and ``broadcast``, which NCCL and gloo both run
on CUDA tensors (gloo also on CPU tensors).
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device

# A rank that never arrives fails the others' rendezvous or collective
# within this time instead of hanging them.
TIMEOUT = timedelta(seconds=60)


def init_group(device: torch.device, backend: str | None = None, **kw) -> None:
    """``init_process_group`` with the backend of ``device`` (NCCL for the
    card, gloo for the CPU) unless ``backend`` names one, and ``TIMEOUT``.
    An NCCL group binds the card of this process (``LOCAL_RANK`` under
    torchrun, else the current one)."""
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        index = device.index
        if index is None:
            index = int(os.environ.get("LOCAL_RANK", torch.cuda.current_device()))
        torch.cuda.set_device(index)
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", index)
    dist.init_process_group(backend, timeout=TIMEOUT, **kw)


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device=None, backend: str | None = None) -> None:
    """Join the process group: ``coordinator`` is rank 0's ``host:port``
    (a ``tcp://`` rendezvous); with no arguments the launcher's environment
    (``env://``: torchrun's ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).  ``device`` None is the card (and raises
    without one); its backend is NCCL, the CPU's gloo; ``backend="gloo"``
    also runs on the card (two ranks on one card, which NCCL refuses)."""
    kw = {"init_method": "env://" if coordinator is None else f"tcp://{coordinator}"}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    init_group(resolve_device(device), backend, **kw)


def gather_film_to_host(film: torch.Tensor) -> np.ndarray | None:
    """Concatenate every process's ``film`` (equal shapes) along the first
    axis, as NumPy on rank 0; other ranks return None.  With one process,
    ``film`` itself.  The analog of the reference's swapchain present: the
    one host hop per frame."""
    film = film.detach().contiguous()
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return film.cpu().numpy()
    parts = [torch.empty_like(film) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, film)
    return torch.cat(parts).cpu().numpy() if dist.get_rank() == 0 else None
