"""Data parallelism over ranks: the counterpart of ``cardiax.parallel``."""

from cardiax_torch.parallel.mesh import (
    batch_sharding,
    get_mesh,
    local_device_count,
    replicate,
    replicate_sharding,
    shard_batch,
)

__all__ = [
    "get_mesh",
    "batch_sharding",
    "replicate_sharding",
    "shard_batch",
    "replicate",
    "local_device_count",
]
