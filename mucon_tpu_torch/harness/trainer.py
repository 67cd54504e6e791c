"""The train loop of `SimpleTrainer` (mucon_tpu/harness/trainer.py:79-601).

One train step: the teacher-forced forward under autograd with this
step's dropout masks, the batch loss, backward, the encoder / decoder
gradient clip, and the optimizer update — through the hand-written
kernels of the residual stack and the BiLSTM recurrence when the model
lives on the card.  `train()` runs epochs over a `PaddedBatchLoader` (the
jax-free `mucon_tpu.data`), steps the scheduler after each epoch and
records the loss scalars every `log_every` iterations.

Each step's masks come from a fresh `torch.Generator` on the model's
device, seeded from (seed, iteration): two trainers with the same seed and
weights draw the same masks, so a kernel run and a plain run can be held
against each other step by step.

Run folders, checkpoints, evaluators, the device batch cache, gradient
accumulation and the device mesh are not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence

import torch

from mucon_tpu.data import PaddedBatchLoader
from mucon_tpu_torch.harness.optim import (
    MultiStepScheduler,
    PlateauScheduler,
    Scheduler,
    clip_grad_norm_partitioned,
    create_optimizer,
    set_learning_rate,
)
from mucon_tpu_torch.models.model import MuConModel, batch_to_tensors

logger = logging.getLogger("mucon_tpu_torch.train")


@dataclasses.dataclass
class TrainConfig:
    """The trainer's options; the defaults are the repo's
    (mucon_tpu/config/defaults.py: trainer.*, tpu.batch_size / pad_multiple)."""

    num_epochs: int = 150
    batch_size: int = 1
    pad_multiple: int = 512
    optimizer: str = "SGD"  # "SGD" | "Adam" (amsgrad)
    learning_rate: float = 0.01
    momentum: float = 0.0
    weight_decay: float = 0.005
    clip_grad_norm_value: float = 100.0  # per group: encoder, decoder
    scheduler: str = "step"  # "none" | "step" | "plateau"
    milestones: Sequence[int] = (70,)
    gamma: float = 0.1
    plateau_mode: str = "max"
    plateau_factor: float = 0.1
    plateau_patience: int = 20
    log_every: int = 20


def train_config_from_cfg(cfg) -> TrainConfig:
    """TrainConfig from a mucon_tpu config node (attribute access only)."""
    tr = cfg.trainer
    if not (tr.clip_grad_norm and tr.clip_grad_norm_separate) \
            or tr.accumulate_grad_every != 1:
        raise NotImplementedError(
            "the port clips the encoder and decoder groups apart and takes "
            "one step per batch"
        )
    return TrainConfig(
        num_epochs=tr.num_epochs,
        batch_size=max(1, cfg.tpu.batch_size),
        pad_multiple=cfg.tpu.pad_multiple,
        optimizer=tr.optimizer,
        learning_rate=tr.learning_rate,
        momentum=tr.momentum,
        weight_decay=tr.weight_decay,
        clip_grad_norm_value=tr.clip_grad_norm_value,
        scheduler=tr.scheduler.name,
        milestones=tuple(tr.scheduler.step.milestones),
        gamma=tr.scheduler.step.gamma,
        plateau_mode=tr.scheduler.plateau.mode,
        plateau_factor=tr.scheduler.plateau.factor,
        plateau_patience=tr.scheduler.plateau.patience,
    )


def create_scheduler(config: TrainConfig) -> Optional[Scheduler]:
    if config.scheduler == "none":
        return None
    if config.scheduler == "step":
        return MultiStepScheduler(config.learning_rate, config.milestones, config.gamma)
    if config.scheduler == "plateau":
        return PlateauScheduler(config.learning_rate, config.plateau_mode,
                                config.plateau_factor, config.plateau_patience)
    raise ValueError(f"Invalid scheduler name ({config.scheduler})")


class SimpleTrainer:
    def __init__(self, train_db, model: MuConModel,
                 config: TrainConfig = TrainConfig(), seed: int = 1,
                 use_kernels: bool = True):
        self.train_db = train_db
        self.model = model
        self.config = config
        self.seed = seed
        self.use_kernels = use_kernels
        self.device = model.device
        self.partition = model.param_partition()
        self.optimizer = create_optimizer(
            model.net.parameters(), config.optimizer, config.learning_rate,
            config.momentum, config.weight_decay,
        )
        self.scheduler = create_scheduler(config)
        self.epoch_num = 0
        self.iter_num = 0
        self.events: List[dict] = []  # the logged loss scalars
        self._loader = None

    def create_train_dataloader(self) -> PaddedBatchLoader:
        if self._loader is None:
            self._loader = PaddedBatchLoader(
                self.train_db, batch_size=self.config.batch_size,
                pad_multiple=self.config.pad_multiple, shuffle=True, seed=self.seed,
                prefetch=1,
            )
        return self._loader

    def step_generator(self) -> torch.Generator:
        """This iteration's mask generator, seeded from (seed, iteration)."""
        return torch.Generator(device=self.device).manual_seed(
            self.seed * 1_000_003 + self.iter_num
        )

    def train_step(self, arrays: dict) -> Dict[str, torch.Tensor]:
        """forward -> loss -> backward -> partitioned clip -> optimizer step
        (trainer.py:397-409).  Returns the loss terms (detached, on the
        device: reading them syncs)."""
        fwd = self.model.forward(arrays, use_kernels=self.use_kernels, train=True,
                                 generator=self.step_generator())
        loss = self.model.loss(fwd, arrays)
        self.optimizer.zero_grad(set_to_none=True)
        loss.main.backward()
        clip_grad_norm_partitioned(self.partition, self.config.clip_grad_norm_value)
        self.optimizer.step()
        return {f.name: getattr(loss, f.name).detach() for f in dataclasses.fields(loss)}

    def _log(self, event: str, step: int, scalars: Dict[str, torch.Tensor], **extra):
        record = dict(event=event, step=step,
                      **{k: float(v) for k, v in scalars.items()}, **extra)
        self.events.append(record)
        logger.info("%s", record)

    def train(self) -> None:
        for epoch in range(self.epoch_num, self.config.num_epochs):
            self.epoch_num = epoch
            self._train_one_epoch()
            if self.scheduler is not None:
                self.scheduler.step()
                set_learning_rate(self.optimizer, self.scheduler.lr)

    def _train_one_epoch(self) -> None:
        t0 = time.perf_counter()
        videos = 0
        scalars = None
        for batch in self.create_train_dataloader():
            arrays = batch_to_tensors(batch, self.device)
            scalars = self.train_step(arrays)
            videos += batch.batch_size
            if self.iter_num % self.config.log_every == 0:
                lr = self.optimizer.param_groups[0]["lr"]
                self._log("train", self.iter_num, scalars, lr=lr,
                          videos_per_sec=videos / (time.perf_counter() - t0))
            self.iter_num += 1
        if scalars is not None:
            self._log("epoch", self.epoch_num, scalars,
                      epoch_seconds=time.perf_counter() - t0)
