"""Data (and tensor) parallelism over a ``torch.distributed`` world."""

from .launch import World, spawn_world, start_world
from .mesh import (
    Mesh,
    create_mesh,
    make_parallel_train_step,
    replicate,
    shard_batch,
    tensor_shard_params,
)

__all__ = [
    "Mesh",
    "create_mesh",
    "shard_batch",
    "replicate",
    "tensor_shard_params",
    "make_parallel_train_step",
    "spawn_world",
    "start_world",
    "World",
]
