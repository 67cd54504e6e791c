"""The experiment loop of `SimpleTrainer` (mucon_tpu/harness/trainer.py:79-713).

* the run folder `<trainer.root>/<exp_name>/<run_number>/` with its
  `config.yaml` snapshot, `events.jsonl` and `metrics/`;
* the epoch loop: train, evaluate every `eval_every` epochs (the metric
  series and an `eval_<i>` event per evaluator), step the scheduler (the
  plateau scheduler on the first evaluator's s_mof_nbg), checkpoint every
  `save_every` epochs, pickle the evaluators' outputs, and one
  `train_phases` event that splits the loop's wall time;
* `save_training` / `load_training(run, epoch)` / `latest_checkpoint` /
  `resume_latest` (`harness/checkpoint.py`), with the retention of
  `trainer.keep_last_checkpoints` and the async writer of
  `trainer.async_checkpoint`.

One train step: the teacher-forced forward under autograd with this step's
dropout masks, the batch loss (with the supervised models' two terms,
which the step returns and the `train` events log beside the others, as
the JAX trainer's `_loss_scalars` does), backward, the encoder / decoder
gradient clip, and the optimizer update.  When the model lives on the card and
`use_kernels_from_cfg` says so, the step runs every train kernel of the JAX
package as a hand-written CUDA kernel: the residual stack and the BiLSTM
recurrence (forward and backward), the teacher-forced decoder chain
(forward and backward), and, with `tpu.use_pallas_loss`, the fused flint
loss.

Each step's masks come from a fresh `torch.Generator` on the model's
device, seeded from (seed, iteration): two trainers with the same seed and
weights draw the same masks, so a kernel run and a plain run can be held
against each other step by step, and a resumed run draws the masks the
uninterrupted run would have.

The device batch cache, device prefetch, gradient accumulation, the other
clip modes, the mesh and free decoding in training are not ported
(`config/support.py` refuses them).
"""

from __future__ import annotations

import contextlib
import dataclasses
import shutil
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from mucon_tpu_torch.config.support import check_supported, use_kernels_from_cfg
from mucon_tpu_torch.data import PaddedBatchLoader
from mucon_tpu_torch.harness.checkpoint import has_checkpoint, load_checkpoint, save_checkpoint
from mucon_tpu_torch.harness.logging import RunLogger, StepTimer
from mucon_tpu_torch.harness.metrics_store import MetricStore
from mucon_tpu_torch.harness.optim import (
    clip_grad_norm_partitioned,
    create_optimizer,
    create_scheduler,
    set_learning_rate,
)
from mucon_tpu_torch.models.model import MuConModel, batch_to_tensors


def _next_run_number(exp_folder: Path) -> int:
    if not exp_folder.exists():
        return 0
    runs = [int(p.name) for p in exp_folder.iterdir() if p.name.isdigit()]
    return max(runs) + 1 if runs else 0


def _epochs_in(folder: Path) -> List[int]:
    """Epoch numbers of the `epoch_<n>` folders under `folder`."""
    if not folder.exists():
        return []
    return [int(p.name[len("epoch_"):]) for p in folder.iterdir()
            if p.name.startswith("epoch_") and p.name[len("epoch_"):].isdigit()]


class SimpleTrainer:
    eval_metric_name_format = "eval_metric_{}"
    log_every = 20  # a "train" event every this many iterations

    def __init__(self, cfg, exp_name: str, train_db, model: MuConModel, device=None,
                 evaluators: Optional[List] = None, run_number: Optional[int] = None,
                 seed: Optional[int] = None):
        check_supported(cfg, model.device)
        if device is not None and torch.device(device).type != model.device.type:
            raise ValueError(f"the model lives on {model.device}, not on {device}")
        self.cfg = cfg
        self.exp_name = exp_name
        self.train_db = train_db
        self.model = model
        self.device = model.device
        self.evaluators = list(evaluators) if evaluators else []
        self.use_kernels = use_kernels_from_cfg(cfg)
        self.save_every = cfg.trainer.save_every
        self.eval_every = cfg.trainer.eval_every

        # the run folder is self-describing: its config snapshot is inside
        self.root = Path(cfg.trainer.root)
        exp_folder = self.root / exp_name
        self.run_number = run_number if run_number is not None else _next_run_number(exp_folder)
        self.run_folder = exp_folder / str(self.run_number)
        self.run_folder.mkdir(parents=True, exist_ok=True)
        cfg.clone().dump_to_file(str(self.run_folder / "config.yaml"))
        self.logger = RunLogger(self.run_folder)
        self.metrics = MetricStore(self.run_folder / "metrics")
        self.timer = StepTimer()

        self.epoch_num = 0
        self.iter_num = 0
        self.seed = cfg.system.seed if seed is None else seed
        # wall time of the epoch loop outside train and eval (metric IO,
        # scheduler, checkpoint starts / waits, callbacks): "train_phases"
        self.phase_seconds: Dict[str, float] = {}
        self.partition = model.param_partition()
        tr = cfg.trainer
        self.optimizer = create_optimizer(model.net.parameters(), tr.optimizer,
                                          tr.learning_rate, tr.momentum, tr.weight_decay)
        self.scheduler = create_scheduler(cfg)
        self._loader = None
        self._save_thread = None

    def create_train_dataloader(self) -> PaddedBatchLoader:
        if self._loader is None:
            self._loader = PaddedBatchLoader(
                self.train_db, batch_size=max(1, self.cfg.tpu.batch_size),
                pad_multiple=self.cfg.tpu.pad_multiple, shuffle=True, seed=self.seed,
                prefetch=max(1, self.cfg.system.num_workers),
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
        clip_grad_norm_partitioned(self.partition, self.cfg.trainer.clip_grad_norm_value)
        self.optimizer.step()
        return {f.name: getattr(loss, f.name).detach() for f in dataclasses.fields(loss)}

    def figure_scheduler_input(self, eval_results) -> dict:
        if self.cfg.trainer.scheduler.name == "plateau" and eval_results:
            return {"metrics": eval_results[0].s_mof_nbg}
        return {}

    def on_finish_epoch(self, epoch_num: int) -> None:
        if (epoch_num + 1) % self.eval_every == 0:
            for evaluator in self.evaluators:
                evaluator.set_checkpointing_folder(self._get_checkpointing_folder())
                evaluator.save_stuff()

    @contextlib.contextmanager
    def _phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phase_seconds[name] = self.phase_seconds.get(name, 0.0) \
                + time.perf_counter() - t0

    def train(self) -> None:
        try:
            self._train_epochs()
        finally:
            # an async checkpoint's failure surfaces even when the loop raised
            self.wait_for_save()

    def _train_epochs(self) -> None:
        t_loop0 = time.perf_counter()
        train_s = evals_s = 0.0
        for epoch in range(self.epoch_num, self.cfg.trainer.num_epochs):
            self.epoch_num = epoch
            t0 = time.perf_counter()
            with self.logger.profile(enabled=epoch == self.cfg.trainer.profile_epoch):
                self._train_one_epoch()
            train_s += time.perf_counter() - t0

            eval_results = []
            if self.evaluators and (epoch + 1) % self.eval_every == 0:
                for i, evaluator in enumerate(self.evaluators):
                    t0 = time.perf_counter()
                    result = evaluator.evaluate(self.model)
                    eval_seconds = time.perf_counter() - t0
                    evals_s += eval_seconds
                    eval_results.append(result)
                    with self._phase("metric_io"):
                        name = self.eval_metric_name_format.format(i + 1)
                        self.metrics[name].set_value(result, epoch)
                        self.metrics[name].save()
                        self.logger.log(
                            f"eval_{i}", epoch, eval_seconds=eval_seconds,
                            eval_phases=evaluator.last_eval_phases,
                            **{k: v for k, v in dataclasses.asdict(result).items()
                               if isinstance(v, (int, float))},
                        )

            if self.scheduler is not None:
                with self._phase("scheduler"):
                    self.scheduler.step(**self.figure_scheduler_input(eval_results))
                    set_learning_rate(self.optimizer, self.scheduler.lr)

            if (epoch + 1) % self.save_every == 0:
                with self._phase("checkpoint_start"):
                    self.save_training()

            with self._phase("callbacks"):
                self.on_finish_epoch(epoch)
        with self._phase("checkpoint_wait"):
            self.wait_for_save()
        loop_s = time.perf_counter() - t_loop0
        accounted = train_s + evals_s + sum(self.phase_seconds.values())
        self.logger.log(
            "train_phases", self.epoch_num,
            loop_seconds=round(loop_s, 3),
            train_seconds=round(train_s, 3),
            eval_seconds=round(evals_s, 3),
            residual_seconds=round(max(0.0, loop_s - accounted), 3),
            **{f"{k}_seconds": round(v, 3) for k, v in sorted(self.phase_seconds.items())},
        )

    def _train_one_epoch(self) -> None:
        t0 = time.perf_counter()
        last = None
        for batch in self.create_train_dataloader():
            scalars = self.train_step(
                batch_to_tensors(batch, self.device, supervised=self.model.supervised))
            self.timer.tick(batch.batch_size)
            if self.iter_num % self.log_every == 0:
                values = {k: float(v) for k, v in scalars.items()}
                vps = self.timer.items_per_sec
                if vps:
                    values["videos_per_sec"] = vps
                values["lr"] = self.optimizer.param_groups[0]["lr"]
                self.logger.log("train", self.iter_num, **values)
            self.iter_num += 1
            last = scalars
        if last is not None:  # one sync: the epoch's last loss terms
            self.logger.log("epoch", self.epoch_num, **{k: float(v) for k, v in last.items()},
                            epoch_seconds=time.perf_counter() - t0)

    # -- checkpointing -----------------------------------------------------
    def _get_checkpointing_folder(self) -> Path:
        folder = self.run_folder / "checkpoints" / f"epoch_{self.epoch_num}"
        folder.mkdir(parents=True, exist_ok=True)
        return folder

    def save_training(self) -> None:
        state = {
            "epoch_num": self.epoch_num,
            "iter_num": self.iter_num,
            "scheduler": self.scheduler.state_dict() if self.scheduler else None,
        }
        self.wait_for_save()  # one writer at a time
        self._save_thread = save_checkpoint(
            self._get_checkpointing_folder(), self.model.net.state_dict(),
            self.optimizer.state_dict(), state,
            async_write=bool(self.cfg.trainer.async_checkpoint),
        )
        self._prune_checkpoints()

    def wait_for_save(self) -> None:
        """Block until an in-flight async checkpoint is written; re-raise
        its writer's error."""
        if self._save_thread is not None:
            thread, self._save_thread = self._save_thread, None
            thread.join()

    def _prune_checkpoints(self) -> None:
        """Keep only the newest trainer.keep_last_checkpoints epoch
        checkpoints (-1 keeps all)."""
        k = int(self.cfg.trainer.keep_last_checkpoints)
        if k < 0:
            return
        folder = self.run_folder / "checkpoints"
        epochs = sorted(_epochs_in(folder))
        for e in epochs[: max(0, len(epochs) - k)]:
            shutil.rmtree(folder / f"epoch_{e}", ignore_errors=True)

    def latest_checkpoint(self, run=None):
        """(run, epoch) of the newest complete checkpoint, or None."""
        run = self.run_number if run is None else run
        folder = self.root / self.exp_name / str(run) / "checkpoints"
        epochs = [e for e in _epochs_in(folder) if has_checkpoint(folder / f"epoch_{e}")]
        return (str(run), max(epochs)) if epochs else None

    def resume_latest(self, run=None) -> bool:
        """Resume from the newest checkpoint if one exists; the epoch loop
        goes on after the stored epoch."""
        found = self.latest_checkpoint(run)
        if found is None:
            return False
        self.load_training(*found)
        self.epoch_num += 1
        return True

    def load_training(self, run, epoch: int) -> None:
        """Restore parameters, optimizer state, counters and the scheduler
        from <root>/<exp>/<run>/checkpoints/epoch_<epoch>/."""
        folder = self.root / self.exp_name / str(run) / "checkpoints" / f"epoch_{epoch}"
        model_state, opt_state, state = load_checkpoint(folder, self.device)
        self.model.net.load_state_dict(model_state, strict=True)
        if opt_state is not None:
            self.optimizer.load_state_dict(opt_state)
        self.epoch_num = state.get("epoch_num", epoch)
        self.iter_num = state.get("iter_num", 0)
        if self.scheduler is not None and state.get("scheduler"):
            self.scheduler.load_state_dict(state["scheduler"])
            set_learning_rate(self.optimizer, self.scheduler.lr)
