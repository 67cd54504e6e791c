"""Multi-card runs on torch.distributed (mucon_tpu/parallel): the mesh of
("data", "seq", "model"), the backbone's column layout and the sharded
steps (`mesh.py`), multi-process runs (`multihost.py`), the sequence
axis's shifts (`halo.py`), the sequence- and channel-parallel backbone
(`sharded_ft.py`) and the collectives staged through the host on a gloo
group of CUDA tensors (`transport.py`)."""

from mucon_tpu_torch.parallel.mesh import (
    batch_specs,
    full_state,
    local_state,
    make_mesh,
    make_sharded_forward,
    make_sharded_train_step,
    mesh_from_config,
    mesh_is_data_only,
    pad_batch_to_multiple,
    param_specs,
    shard_batch_arrays,
    shard_params,
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
    "param_specs",
    "shard_params",
    "full_state",
    "local_state",
    "init_distributed",
    "is_coordinator",
    "make_multihost_mesh",
    "process_batch_slice",
    "shard_batch_arrays_multihost",
]
