"""Process-group set-up and the pod mesh (port of
visualcla_tpu/parallel/distributed.py).

One process per device, as ``torchrun --nproc_per_node N`` starts them:
``initialize`` reads torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``
/ ``MASTER_ADDR`` / ``MASTER_PORT`` (or takes them as arguments) and brings
up ``torch.distributed`` on NCCL for ``cuda`` and gloo for ``cpu``.
"""
from __future__ import annotations

import logging
import os
from datetime import timedelta
from typing import Optional

import torch

logger = logging.getLogger(__name__)


def initialize(device: str = "cuda", *, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               timeout_s: float = 600.0) -> None:
    """Bring up the default process group (a no-op when it is up already).

    ``init_method`` defaults to ``env://`` (torchrun's ``MASTER_ADDR`` /
    ``MASTER_PORT``); a ``file://`` store needs no network.  ``world_size``
    and ``rank`` default to ``WORLD_SIZE`` / ``RANK`` (1 and 0 without them).
    On ``cuda`` the process takes device ``LOCAL_RANK`` (default: the rank
    modulo the visible devices)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    if init_method is None:
        init_method = "env://"
        os.environ.setdefault("MASTER_ADDR", "localhost")
        os.environ.setdefault("MASTER_PORT", "29500")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(
            int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1))))
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    logger.info("torch.distributed up: rank %d/%d on %s", rank, world_size, backend)


def rank() -> int:
    """This process's rank (0 without a process group)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    """The processes of this run: the group's, else torchrun's ``WORLD_SIZE``."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", 1))


def pod_mesh(n_data: Optional[int] = None):
    """The global (data, model) mesh: ``data`` across nodes (only the batch's
    gather crosses them), ``model`` within a node (default: ``n_data`` the
    node count, from torchrun's ``LOCAL_WORLD_SIZE``)."""
    import torch.distributed as dist

    from .sharding import make_mesh

    world = dist.get_world_size()
    if n_data is None:
        per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        n_data = max(1, world // per_node)
    return make_mesh(n_data, world // n_data)
