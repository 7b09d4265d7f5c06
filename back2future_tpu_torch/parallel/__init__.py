"""Device mesh, batch placement and data-parallel process groups
(counterpart of back2future_tpu.parallel): a `data` axis over devices for
serving, DDP ranks over NCCL or gloo for training, and a `spatial` axis
that shards image rows over threads (serving) or ranks (training), with
the halo exchanges of parallel/spatial.py. Of JAX's `__all__`, the shardings
`batch_sharding` / `replicated_sharding` and `make_global_batch` have no
tensor counterpart (parallel/mesh.py, parallel/distributed.py)."""

from .mesh import (
    make_mesh,
    shard_batch,
    replicate,
)
from .distributed import (
    initialize_multihost,
    host_local_batch_size,
)

__all__ = [
    "make_mesh", "shard_batch", "replicate",
    "initialize_multihost", "host_local_batch_size",
]
