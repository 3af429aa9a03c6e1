"""Data parallelism on torch.distributed (`mesh.py`)."""

from .mesh import (all_gather_rows, all_reduce_mean, backend, barrier,
                   broadcast_scalar, collective_device, describe, destroy,
                   is_initialized, maybe_initialize_distributed, rank, world)

__all__ = [
    "all_gather_rows", "all_reduce_mean", "backend", "barrier",
    "broadcast_scalar", "collective_device", "describe", "destroy",
    "is_initialized", "maybe_initialize_distributed", "rank", "world",
]
