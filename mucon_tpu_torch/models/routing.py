"""Kernel routing (mucon_tpu/models/routing.py and the routes of
mucon_tpu/models/{model,mucon,lstm}.py).

Which path each part of the model takes is decided before the call, from
the config, the tensors' dtype and the model's shape, by the JAX
package's own rules; it is never decided by catching a kernel's failure,
and no kernel wrapper gives way to its plain twin.  Each distinct decision
is logged once, as one INFO line on the `mucon_tpu_torch.kernel_routing`
logger (`log_route`).

A route "on" means the kernel path of the JAX package: there the work goes
through the kernel's wrapper, which launches the CUDA kernel on a CUDA
tensor and runs its plain twin on a CPU tensor.  A route "off" is the JAX
package's XLA path, here plain PyTorch.

* `resolve_flag` — a tri-state `tpu.use_pallas*` value: True or False
  force, "auto" is on (the kernels run where the tensors live on the card,
  their plain twins on the CPU).
* `KernelRoutes` — one switch a kernel, `routes_from_cfg` reads them from
  the flags as mucon_tpu/models/model.py and mucon.py read them.  The JAX
  package also routes on its TPU's VMEM budgets (model.py:234-241,
  lstm.py:149-157, `plan_eval_slices`); those are not copied: a kernel
  here takes the shape or raises.
* On a mesh whose "seq" or "model" axis is above 1 (`parallel/`), the
  stack kernels (`stack`, `stack_train`, both operand modes) give way to
  the plain sharded backbone (`parallel/sharded_ft.py`): they cannot
  exchange rows or columns between layers.  The kernels after the
  backbone's gather keep their routes: they see the tensors a one-rank run
  gives them.  (The JAX package runs the whole forward on XLA there,
  because GSPMD cannot partition a `pallas_call`.)  `MuConModel` logs that
  decision once like the others.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, fields

logger = logging.getLogger("mucon_tpu_torch.kernel_routing")
_logged_routes = set()


def log_route(msg: str) -> None:
    """One INFO line per distinct routing decision."""
    if msg not in _logged_routes:
        _logged_routes.add(msg)
        logger.info(msg)


def resolve_flag(value) -> bool:
    """A tri-state kernel flag: "auto" or True -> on, False -> off."""
    if isinstance(value, str):
        if value == "auto":
            return True
        raise ValueError(f"Invalid pallas flag {value!r} (use 'auto'|True|False)")
    return bool(value)


@dataclass(frozen=True)
class KernelRoutes:
    """The kernel routes of a run, one a kernel (the flag it follows):

    * `stack` — the eval stacks, WaveNet and MS-TCN++ (`tpu.use_pallas`,
      model.py:134-137, 162);
    * `stack_train` — the trainable WaveNet stack (`tpu.use_pallas` and
      `tpu.use_pallas_train`, model.py:138-144, 165-169);
    * `lstm`, `lstm_train` — the BiLSTM recurrence in eval and in train
      (`tpu.use_pallas_lstm`, `tpu.use_pallas_lstm_train`,
      mucon.py:207-213); it also needs a bidirectional encoder and an f32
      input (lstm.py:135-145);
    * `decoder` — the teacher-forced decoder chain (`tpu.use_pallas_decoder`,
      model.py:218); off under bf16 compute (model.py:222);
    * `viterbi` — the fused eval's dense Viterbi DP (`tpu.use_pallas`,
      harness/evaluator.py:536).

    The flint loss kernel has its own switch (`tpu.use_pallas_loss`,
    `models/losses.py loss_config_from_cfg`)."""

    stack: bool = True
    stack_train: bool = True
    lstm: bool = True
    lstm_train: bool = True
    decoder: bool = True
    viterbi: bool = True

    @classmethod
    def every(cls, on: bool) -> "KernelRoutes":
        return cls(**{f.name: bool(on) for f in fields(cls)})


def as_routes(use_kernels) -> KernelRoutes:
    """`use_kernels` as routes: a bool turns every kernel on or off."""
    if isinstance(use_kernels, KernelRoutes):
        return use_kernels
    return KernelRoutes.every(bool(use_kernels))


def routes_from_cfg(cfg) -> KernelRoutes:
    """The routes a config's `tpu.use_pallas*` flags select."""
    tpu = cfg.tpu
    eval_stack = resolve_flag(tpu.use_pallas)
    return KernelRoutes(
        stack=eval_stack,
        stack_train=eval_stack and resolve_flag(tpu.use_pallas_train),
        lstm=resolve_flag(tpu.use_pallas_lstm),
        lstm_train=resolve_flag(tpu.use_pallas_lstm_train),
        decoder=resolve_flag(tpu.use_pallas_decoder),
        viterbi=eval_stack,
    )
