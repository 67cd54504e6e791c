"""What of the config tree the port runs.

* `UNPORTED`: options the port does not implement yet.  Each raises
  `NotImplementedError` when set away from the values listed, so that a run
  never quietly computes something other than what its config says.
* `NOT_APPLICABLE`: options that only steer the JAX package on a TPU (its
  compile cache, scan unrolling, rematerialisation, the v2 sweep's program
  count, the async dispatch depth, the full-length decode scan, the mesh
  shape).  They are accepted, and each is logged once when set away from
  its default.
* `use_kernels_from_cfg`: the `tpu.use_pallas*` flags onto the port's one
  `use_kernels` switch.
* `device_from_cfg`: `system.device` as a `torch.device`.
"""

from __future__ import annotations

import logging

import torch

from mucon_tpu_torch import resolve_device

logger = logging.getLogger("mucon_tpu_torch.config")

UNPORTED = {
    "trainer.accumulate_grad_every": (1,),
    "trainer.clip_grad_norm": (True,),
    "trainer.clip_grad_norm_separate": (True,),
    "trainer.clip_grad_norm_every_param": (False,),
    "model.name": ("mucon",),
    "model.teacher_forcing": (True,),
    "tpu.compute_dtype": ("float32",),
    "tpu.cache_batches": (False,),
    "tpu.cache_budget_gb": (0.0,),
    "tpu.cache_budget_eval_gb": (0.0,),
    "tpu.feats_transfer_dtype": ("auto", "float32"),
    "tpu.eval_feats_transfer_dtype": ("auto", "float32"),
    "tpu.kernel_mm_dtype": ("auto", "float32"),
    "tpu.in_proj_mm_dtype": ("auto", "float32"),
    "tpu.device_prefetch": (1,),
    "tpu.mesh.multihost": (False,),
}
NOT_APPLICABLE = {
    "tpu.compilation_cache_dir": "",
    "tpu.scan_unroll": "auto",
    "tpu.remat": False,
    "tpu.train_sweep_chunks": 3,
    "tpu.eval_pipeline_depth": 8,
    "tpu.early_exit_decode": True,  # the port's free decode always stops at EOS
    "tpu.mesh.data": -1,
    "tpu.mesh.seq": 1,
    "tpu.mesh.model": 1,
}
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


def check_supported(cfg, device=None) -> None:
    """Raise on an option the port does not implement; log, once, each
    TPU-only option set away from its default.  With `device`, also refuse
    a mesh over more than one card."""
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
    use_kernels_from_cfg(cfg)
    if device is not None and cfg.tpu.mesh.enable:
        device = torch.device(device)
        if device.type == "cuda" and torch.cuda.device_count() > 1:
            raise NotImplementedError("tpu.mesh.enable over more than one card is not "
                                      "ported to mucon_tpu_torch")


def use_kernels_from_cfg(cfg) -> bool:
    """True when every `tpu.use_pallas*` flag of the encoder, BiLSTM,
    decoder and eval paths is "auto" or True (the kernels run wherever the
    model lives on the card), False when every one is False (the plain
    path, chosen explicitly); a mix raises.  `tpu.use_pallas_loss` has its
    own switch (`models/losses.py loss_config_from_cfg`)."""
    values = {k: _get(cfg, k) for k in KERNEL_FLAGS}
    if all(_is(v, ("auto", True)) for v in values.values()):
        return True
    if all(_is(v, (False,)) for v in values.values()):
        return False
    raise NotImplementedError(
        f"the port runs every kernel or none: {values} mixes them")


def device_from_cfg(cfg) -> torch.device:
    """`system.device` as a torch.device; a JAX run folder's "tpu" (and
    "gpu") reads as the card."""
    name = str(cfg.system.device)
    return resolve_device({"tpu": "cuda", "gpu": "cuda"}.get(name, name))
