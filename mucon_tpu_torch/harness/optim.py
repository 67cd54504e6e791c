"""Optimizers, schedulers and the partitioned gradient clip
(mucon_tpu/harness/optim.py).

The reference trains with torch's optimizers (trainers.py:18-56, 133-146):

* the encoder and decoder parameter groups are clipped apart, each to a
  global norm of 100 (or, as `trainer.clip_*` say, all together, each
  parameter alone, or not at all: `clip_gradients`);
* SGD or Adam(amsgrad), weight decay coupled into the gradient after the
  clip (torch adds wd * p to the gradient before momentum / moments — the
  JAX package's optax chain clip -> add_decayed_weights -> sgd/amsgrad);
* MultiStepLR / ReduceLROnPlateau, stepped once per epoch.

No Pallas kernel sits on this path, so `torch.optim` runs the updates.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import torch

# the squared gradient norm of each group of parameters
NormSq = Callable[[List[List[torch.Tensor]]], List[torch.Tensor]]


def local_norm_sq(groups: List[List[torch.Tensor]]) -> List[torch.Tensor]:
    """Each group's squared global gradient norm, in f32, on this rank."""
    return [sum(torch.sum(p.grad.float() ** 2) for p in ps) for ps in groups]


@torch.no_grad()
def clip_grad_norm_partitioned(params_by_label: Dict[str, List[torch.Tensor]],
                               max_norm: float, norm_sq: NormSq = local_norm_sq
                               ) -> Dict[str, torch.Tensor]:
    """Scale each group's gradients so that the group's global norm is at
    most `max_norm`; returns the norms before clipping.  `norm_sq` gives
    the groups' squared norms (under a "model" mesh, of whole leaves:
    `parallel/mesh.py model_norm_sq`)."""
    groups = {label: [p for p in params if p.grad is not None]
              for label, params in params_by_label.items()}
    groups = {label: ps for label, ps in groups.items() if ps}
    norms = {}
    for (label, params), sq in zip(groups.items(), norm_sq(list(groups.values()))):
        norm = torch.sqrt(sq)
        factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        for p in params:
            p.grad.mul_(factor)
        norms[label] = norm
    return norms


@torch.no_grad()
def clip_grad_norm_global(params: Iterable[torch.Tensor], max_norm: float,
                          norm_sq: NormSq = local_norm_sq) -> None:
    """optax's `clip_by_global_norm` over every gradient together: `g`
    where the global norm is below `max_norm`, else `(g / norm) * max_norm`
    (not `torch.nn.utils.clip_grad_norm_`, whose max_norm / (norm + 1e-6)
    parts from it)."""
    params = [p for p in params if p.grad is not None]
    if not params:
        return
    norm = torch.sqrt(norm_sq([params])[0])
    keep = norm < max_norm
    for p in params:
        p.grad.copy_(torch.where(keep, p.grad, (p.grad / norm) * max_norm))


@torch.no_grad()
def clip_grad_norm_per_parameter(params: Iterable[torch.Tensor], max_norm: float,
                                 norm_sq: NormSq = local_norm_sq) -> None:
    """Each gradient scaled by min(1, max_norm / max(its norm, 1e-12))
    (optim.py:61-75)."""
    params = [p for p in params if p.grad is not None]
    for p, sq in zip(params, norm_sq([[p] for p in params])):
        norm = torch.sqrt(sq)
        p.grad.mul_(torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0))


def clip_gradients(trainer_cfg, params_by_label: Dict[str, List[torch.Tensor]],
                   norm_sq: NormSq = local_norm_sq) -> None:
    """The clip that `trainer.clip_grad_norm*` name, chosen in the order of
    the JAX `create_optimizer` (optim.py:119-126): none without
    `clip_grad_norm`; else the encoder and decoder groups apart with
    `clip_grad_norm_separate`; else each parameter alone with
    `clip_grad_norm_every_param`; else all together.  Every mode takes its
    squared norms from `norm_sq`."""
    if not trainer_cfg.clip_grad_norm:
        return
    max_norm = trainer_cfg.clip_grad_norm_value
    params = [p for group in params_by_label.values() for p in group]
    if trainer_cfg.clip_grad_norm_separate:
        clip_grad_norm_partitioned(params_by_label, max_norm, norm_sq)
    elif trainer_cfg.clip_grad_norm_every_param:
        clip_grad_norm_per_parameter(params, max_norm, norm_sq)
    else:
        clip_grad_norm_global(params, max_norm, norm_sq)


def create_optimizer(params: Iterable[torch.Tensor], name: str = "SGD",
                     learning_rate: float = 0.01, momentum: float = 0.0,
                     weight_decay: float = 0.005) -> torch.optim.Optimizer:
    """SGD(momentum, coupled wd) or Adam(amsgrad, coupled wd); the defaults
    are the repo's (mucon_tpu/config/defaults.py:49-57)."""
    params = list(params)
    if name == "SGD":
        return torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                               weight_decay=weight_decay)
    if name == "Adam":
        return torch.optim.Adam(params, lr=learning_rate, amsgrad=True,
                                weight_decay=weight_decay)
    raise ValueError(f"Invalid optimizer name ({name})")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


class Scheduler:
    """Epoch-granular scheduler: call step(...) after each epoch, read .lr
    before the next one."""

    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.lr = base_lr

    def step(self, **kwargs) -> None:
        raise NotImplementedError

    def state_dict(self) -> dict:
        return {"lr": self.lr}

    def load_state_dict(self, d: dict) -> None:
        self.lr = d["lr"]


class MultiStepScheduler(Scheduler):
    """torch MultiStepLR: lr *= gamma at each milestone epoch."""

    def __init__(self, base_lr: float, milestones, gamma: float):
        super().__init__(base_lr)
        self.milestones = sorted(milestones)
        self.gamma = gamma
        self.epoch = 0

    def step(self, **kwargs) -> None:
        self.epoch += 1
        if self.epoch in self.milestones:
            self.lr *= self.gamma

    def state_dict(self) -> dict:
        return {"lr": self.lr, "epoch": self.epoch}

    def load_state_dict(self, d: dict) -> None:
        self.lr, self.epoch = d["lr"], d["epoch"]


class PlateauScheduler(Scheduler):
    """torch ReduceLROnPlateau (mode max/min, factor, patience), stepped on
    the first evaluator's s_mof_nbg (mucon_tpu/harness/trainer.py:351-354)."""

    def __init__(self, base_lr, mode="max", factor=0.1, patience=20, verbose=False):
        super().__init__(base_lr)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.best: Optional[float] = None
        self.num_bad = 0

    def step(self, metrics: float = None, **kwargs) -> None:
        if metrics is None:
            return
        better = self.best is None or (
            metrics > self.best if self.mode == "max" else metrics < self.best
        )
        if better:
            self.best = metrics
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr *= self.factor
                self.num_bad = 0
                if self.verbose:
                    print(f"[plateau] reducing lr to {self.lr}")

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d: dict) -> None:
        self.lr, self.best, self.num_bad = d["lr"], d["best"], d["num_bad"]


def create_scheduler(cfg) -> Optional[Scheduler]:
    """The scheduler that `trainer.scheduler` names (trainers.py:39-56)."""
    name = cfg.trainer.scheduler.name
    base_lr = cfg.trainer.learning_rate
    if name == "none":
        return None
    if name == "plateau":
        p = cfg.trainer.scheduler.plateau
        return PlateauScheduler(base_lr, mode=p.mode, factor=p.factor, patience=p.patience,
                                verbose=p.verbose)
    if name == "step":
        s = cfg.trainer.scheduler.step
        return MultiStepScheduler(base_lr, s.milestones, s.gamma)
    raise ValueError(f"Invalid scheduler name ({name})")
