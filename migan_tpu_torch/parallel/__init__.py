"""Data parallelism (`mesh.py`) and spatial (image-height) sharding of
the generator forward (`spatial.py`) on torch.distributed."""

from .mesh import (all_gather_rows, all_reduce_mean, backend, barrier,
                   broadcast_scalar, collective_device, describe, destroy,
                   is_initialized, maybe_initialize_distributed, rank, world)
from .spatial import (gather_rows, generator_apply_spatial, halo_rows,
                      shard_rows)

__all__ = [
    "all_gather_rows", "all_reduce_mean", "backend", "barrier",
    "broadcast_scalar", "collective_device", "describe", "destroy",
    "gather_rows", "generator_apply_spatial", "halo_rows",
    "is_initialized", "maybe_initialize_distributed", "rank", "shard_rows",
    "world",
]
