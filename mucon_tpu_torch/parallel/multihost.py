"""Multi-process runs on torch.distributed (mucon_tpu/parallel/multihost.py).

The JAX package drives a host's chips from one process and joins hosts
with `jax.distributed`.  The port runs one process a card: `torchrun` (or
`python -m torch.distributed.run`) starts them and exports RANK,
LOCAL_RANK, WORLD_SIZE, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT.  A
single node's eight cards are eight ranks; several nodes are ranks across
nodes, and the node dimension lies on the mesh's "data" axis, so the one
all-reduce of a step is the only collective that crosses nodes.

What each process does (the JAX package's recipe, multihost.py:23-40):

1. `init_distributed()` before anything touches a card (the CLI entries
   call it from `cli/common.py compose_config`);
2. builds the mesh (`make_multihost_mesh`, or `run_mesh` from a config);
3. moves only its own rows of the collated batch to its card
   (`process_batch_slice`, `shard_batch_arrays_multihost`); every process
   reads and collates the whole batch, from loaders seeded alike;
4. writes checkpoints and eval pickles only on the coordinator
   (`is_coordinator`); the logged losses and eval fields are averaged or
   gathered over the ranks, so every rank logs the same numbers.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from mucon_tpu_torch.parallel.mesh import data_rows, make_mesh, mesh_from_config

logger = logging.getLogger("mucon_tpu_torch.multihost")


def distributed_env_configured() -> bool:
    """True when the environment declares a launch of several processes
    (a launcher exported WORLD_SIZE above 1)."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def world_size() -> int:
    """The ranks of this run (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    """This process's index among its node's ranks (LOCAL_RANK)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     auto: bool = False, backend: Optional[str] = None) -> tuple:
    """Join the run's process group when a launch is configured; returns
    (rank, world size) (multihost.py:87-157).

    A launch is configured by `coordinator_address` ("host:port", or an
    init URL such as "tcp://host:port" or "file:///path") or by the
    launcher's env (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT); explicit
    arguments win over the env.  Without either it returns (0, 1), and with
    `auto` (the CLI passes `tpu.mesh.multihost`) it logs that the run is
    single-process.  Idempotent: with a group already made it returns its
    (rank, world size).  `backend` defaults to NCCL when the process sees a
    card, else gloo; under NCCL the process takes card LOCAL_RANK
    (`torch.cuda.set_device`) before anything touches one, and a rank
    that cannot join raises."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if coordinator_address is None and num_processes is None and "WORLD_SIZE" not in env:
        if auto:
            logger.info("tpu.mesh.multihost set but no distributed environment detected "
                        "(no WORLD_SIZE from a launcher); running single-process")
        return 0, 1
    world = int(env["WORLD_SIZE"]) if num_processes is None else int(num_processes)
    rank_ = int(env.get("RANK", 0)) if process_id is None else int(process_id)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank_ % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init_method, rank=rank_, world_size=world)
    logger.info("torch.distributed initialized: rank %d / %d on %s", rank_, world, backend)
    return rank_, world


def is_coordinator() -> bool:
    """True on the process that writes checkpoints and eval pickles: rank 0
    (multihost.py:160-163)."""
    return rank() == 0


def make_multihost_mesh(n_data: int = -1, n_seq: int = 1, n_model: int = 1,
                        device_type: Optional[str] = None):
    """The ("data", "seq", "model") mesh over every rank (multihost.py:
    166-212).  A launcher numbers a node's ranks consecutively, so a data
    row (seq * model consecutive ranks) lies inside one node when the
    node's rank count is a multiple of seq * model; anything else raises.
    With one process it is `make_mesh`."""
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))
    if per_node % (n_seq * n_model):
        raise ValueError(f"seq * model = {n_seq * n_model} must divide the {per_node} ranks "
                         "of a node: only the data axis may cross nodes")
    return make_mesh(n_data, n_seq, n_model, device_type)


def run_mesh(cfg, device_type: Optional[str] = None):
    """The mesh a trainer or an evaluator of `cfg` runs on, or None
    (trainer.py:167-221): with `tpu.mesh.enable` and either
    `tpu.mesh.multihost` or more than one rank.  Like the JAX package, a
    single process builds a mesh (of one rank) only with multihost."""
    mesh_cfg = cfg.tpu.mesh
    if not mesh_cfg.enable:
        return None
    if mesh_cfg.multihost:
        init_distributed()  # idempotent: the CLI entries joined already
        return make_multihost_mesh(int(mesh_cfg.data), int(mesh_cfg.seq),
                                   int(mesh_cfg.model), device_type)
    if world_size() > 1:
        return mesh_from_config(cfg, device_type)
    return None


def process_batch_slice(global_batch: int, mesh) -> slice:
    """The rows of the global padded batch this process moves to its card,
    from its coordinate on the mesh's "data" axis (multihost.py:215-256)."""
    return data_rows(mesh, global_batch)


def shard_batch_arrays_multihost(mesh, local_arrays: dict, device) -> dict:
    """The `process_batch_slice` rows a process holds, on its `device`
    (multihost.py:259-276): with one process, `shard_batch_arrays`."""
    rows = {v.shape[0] for v in local_arrays.values()}
    if len(rows) != 1:
        raise ValueError(f"the batch tensors disagree on their rows: {sorted(rows)}")
    return {k: v.to(device) for k, v in local_arrays.items()}
