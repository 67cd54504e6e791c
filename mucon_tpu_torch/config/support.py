"""What of the config tree the port runs.

* `UNPORTED`: options the port does not implement yet.  Each raises
  `NotImplementedError` when set away from the values listed, so that a run
  never quietly computes something other than what its config says.
* `NOT_APPLICABLE`: options that only steer the JAX package on a TPU (its
  compile cache, scan unrolling, rematerialisation, the v2 sweep's program
  count, the async dispatch depth, the full-length decode scan).  They are
  accepted, and each is logged once when set away from its default.  So
  are the mesh's "seq" and "model" axes on one rank, where the JAX package
  builds no mesh either (`MESH_AXES`).
* The mesh (`tpu.mesh.enable`, `tpu.mesh.multihost`, `tpu.mesh.{data,seq,
  model}`) runs over any number of ranks (`parallel/`).  As in the JAX
  package (trainer.py:186-196), `tpu.mesh.multihost` with "model" above 1
  over several processes raises: there every rank is a process.
* `KERNEL_FLAGS`: the `tpu.use_pallas*` flags of the encoder, BiLSTM,
  decoder and eval paths; `models/routing.py routes_from_cfg` reads them
  into one switch a kernel (any mix runs, as in the JAX package).
* `device_from_cfg`: `system.device` as a `torch.device`, the process's own
  card (LOCAL_RANK) in a launch of several processes.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from mucon_tpu_torch import resolve_device
from mucon_tpu_torch.models.routing import routes_from_cfg
from mucon_tpu_torch.parallel import multihost

logger = logging.getLogger("mucon_tpu_torch.config")

UNPORTED = {
    "model.name": ("mucon",),
}
NOT_APPLICABLE = {
    "tpu.compilation_cache_dir": "",
    "tpu.scan_unroll": "auto",
    "tpu.remat": False,
    "tpu.train_sweep_chunks": 3,
    "tpu.eval_pipeline_depth": 8,
    "tpu.early_exit_decode": True,  # the port's free decode always stops at EOS
}
MESH_AXES = ("tpu.mesh.seq", "tpu.mesh.model")
KERNEL_FLAGS = ("tpu.use_pallas", "tpu.use_pallas_train", "tpu.use_pallas_lstm",
                "tpu.use_pallas_lstm_train", "tpu.use_pallas_decoder")
_logged = set()


def _get(cfg, key: str):
    node = cfg
    for part in key.split("."):
        node = node[part]
    return node


def _is(value, allowed) -> bool:
    # `1 == True` in Python: a bool matches only a bool
    return any(value == a and isinstance(value, bool) == isinstance(a, bool)
               for a in allowed)


def check_supported(cfg, world_size: Optional[int] = None) -> None:
    """Raise on an option the port does not implement; log, once, each
    TPU-only option set away from its default.  `world_size` is the ranks
    of the run (default: the process group's, 1 without one)."""
    for key, allowed in UNPORTED.items():
        value = _get(cfg, key)
        if not _is(value, allowed):
            raise NotImplementedError(
                f"{key}={value!r} is not ported to mucon_tpu_torch (it runs "
                f"{' or '.join(map(repr, allowed))})")
    for key, default in NOT_APPLICABLE.items():
        value = _get(cfg, key)
        if not _is(value, (default,)) and key not in _logged:
            _logged.add(key)
            logger.info("%s=%r only steers the JAX package on a TPU: not applicable "
                        "here", key, value)
    routes_from_cfg(cfg)  # an invalid flag raises here
    mesh = cfg.tpu.mesh
    if world_size is None:
        world_size = multihost.world_size()
    for key in MESH_AXES:
        value = _get(cfg, key)
        if world_size == 1 and int(value) != 1 and key not in _logged:
            _logged.add(key)
            logger.info("%s=%r on one rank: not applicable (no mesh splits one rank)",
                        key, value)
    if mesh.enable and mesh.multihost and world_size > 1 and int(mesh.model) > 1:
        raise NotImplementedError(
            f"tpu.mesh.multihost with model-sharded params (tpu.mesh.model={mesh.model}) "
            f"over {world_size} processes is not supported: the JAX package refuses it "
            "(its single-writer checkpoint needs every leaf whole on the coordinator, "
            "trainer.py:186-196). Use tpu.mesh.model=1 across processes, or launch on one "
            "node without tpu.mesh.multihost")


def device_from_cfg(cfg) -> torch.device:
    """`system.device` as a torch.device; a JAX run folder's "tpu" (and
    "gpu") reads as the card, and in a launch of several processes "cuda"
    reads as the process's own card, cuda:LOCAL_RANK."""
    name = str(cfg.system.device)
    device = resolve_device({"tpu": "cuda", "gpu": "cuda"}.get(name, name))
    if device.type == "cuda" and device.index is None and multihost.world_size() > 1:
        device = torch.device("cuda", multihost.local_rank())
    return device
