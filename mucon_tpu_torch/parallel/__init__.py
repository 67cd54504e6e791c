"""Multi-card data parallelism on torch.distributed (mucon_tpu/parallel):
the mesh and the data-parallel steps (`mesh.py`), multi-process runs
(`multihost.py`) and the sequence axis's halo exchange (`halo.py`).  The
"model" axis (`param_specs`, `shard_params`) is not ported."""

from mucon_tpu_torch.parallel.mesh import (
    batch_specs,
    make_mesh,
    make_sharded_forward,
    make_sharded_train_step,
    mesh_from_config,
    mesh_is_data_only,
    pad_batch_to_multiple,
    shard_batch_arrays,
)
from mucon_tpu_torch.parallel.multihost import (
    init_distributed,
    is_coordinator,
    make_multihost_mesh,
    process_batch_slice,
    shard_batch_arrays_multihost,
)

__all__ = [
    "make_mesh",
    "mesh_from_config",
    "mesh_is_data_only",
    "batch_specs",
    "shard_batch_arrays",
    "pad_batch_to_multiple",
    "make_sharded_train_step",
    "make_sharded_forward",
    "init_distributed",
    "is_coordinator",
    "make_multihost_mesh",
    "process_batch_slice",
    "shard_batch_arrays_multihost",
]
