"""Multi-device runs: one process (rank) per device over
``torch.distributed`` (``distributed.py``), the (data, spatial) mesh of
ranks (``mesh.py``), the depth halo exchange (``halo.py``) and a one-host
launcher (``launch.py``).
Counterpart of ``ctunet_tpu/parallel``."""

from .distributed import (all_reduce_mean, barrier_wait, choose_backend,
                          initialize_from_params, is_initialized,
                          local_batch_size, rank_and_world, rank_device)
from .halo import crop, halo_exchange_many, join
from .launch import free_port, spawn
from .mesh import DATA_AXIS, SPATIAL_AXIS, Mesh, make_mesh

__all__ = [
    "DATA_AXIS",
    "SPATIAL_AXIS",
    "Mesh",
    "all_reduce_mean",
    "barrier_wait",
    "choose_backend",
    "crop",
    "free_port",
    "halo_exchange_many",
    "initialize_from_params",
    "is_initialized",
    "join",
    "local_batch_size",
    "make_mesh",
    "rank_and_world",
    "rank_device",
    "spawn",
]
