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

One train step: the forward under autograd with this step's dropout masks,
teacher-forced or, with `model.teacher_forcing=False` (set on the model at
the start of each epoch, `on_start_epoch`), free decoding, the batch loss
(with the supervised models' two terms, which the step returns and the
`train` events log beside the others, as the JAX trainer's
`_loss_scalars` does), backward, the gradient clip that `trainer.clip_*`
name (`harness/optim.py clip_gradients`: the encoder and decoder groups
apart by default), and the optimizer update.  With
`trainer.accumulate_grad_every` k > 1, each iteration backpropagates
loss / k into the summed gradients and every k-th applies them
(trainer.py:413-445, 554-602); a partial accumulation at the end of an
epoch is dropped.  When the model lives on the card, the step runs each
train kernel of the JAX package whose route is on (`models/routing.py
routes_from_cfg`, from the `tpu.use_pallas*` flags) as a hand-written CUDA
kernel: the residual stack and the BiLSTM recurrence (forward and
backward), the teacher-forced decoder chain (forward and backward; not in
a free-decoding step, and not under bf16 compute) and, with
`tpu.use_pallas_loss`, the fused flint loss.

Each step's masks come from a fresh `torch.Generator` on the model's
device, seeded from (seed, iteration): two trainers with the same seed and
weights draw the same masks, so a kernel run and a plain run can be held
against each other step by step, and a resumed run draws the masks the
uninterrupted run would have.

The data path (trainer.py:138-165, 288-349):
* the features travel on the wire `tpu.feats_transfer_dtype` names
  (`models/model.py resolve_feats_dtype`: float32, float16, bfloat16 or
  int8 with a per-frame scale; "auto" is bfloat16 under bf16 compute);
* `tpu.device_prefetch` k > 0 issues each batch's copy k batches ahead of
  the step that reads it; on the card from pinned host memory with
  `non_blocking` copies on a side stream, an event the compute stream
  waits on before the step, and `record_stream` on the tensors that cross
  streams.  torch's pinned allocator reuses a host block only once the
  copy's recorded event has completed.  On the CPU the same generator runs
  without streams; every k gives the same trajectory bit for bit;
* `tpu.cache_batches` freezes the batches' composition
  (`PaddedBatchLoader(fixed_batches=True)`) and keeps each batch's device
  tensors, within the byte budget that the trainer shares with its
  evaluators (`harness/cache.py`).  Once every batch is cached, an epoch
  replays them in the loader's own shuffled order without reading,
  collating or copying anything.

The mesh (trainer.py:167-221, `parallel/`): with `tpu.mesh.enable` and
either `tpu.mesh.multihost` or more than one rank, the trainer runs on the
mesh of `tpu.mesh.{data,seq,model}`.  The weights start as the one-rank
init; with "model" above 1 each rank keeps its columns of the backbone's
leaves (`shard_params`).  The replicas start from data rank 0's weights
(broadcast: the backbone's columns over the ("data", "seq") group, the
rest over the whole mesh), the loader keeps only batches the data axis divides
(`batch_divisor`), each rank moves only its own rows (and, with "seq"
above 1, its time block) of a batch to its card, and the step
(`parallel/mesh.py make_sharded_train_step`; with accumulation
`make_sharded_grad_step` then `apply_gradients`) reduces the gradients
before the clip, whose norms are of whole leaves (`model_norm_sq`).  The
loss terms are averaged too, so every rank logs the same numbers; each
rank folds its data coordinate, and only that, into its mask seed (data
rank 0 keeps the single-card seed).  Every rank keeps its own run folder,
logger and metric store; only the coordinator (rank 0) writes
checkpoints, after every rank has joined the all-gather of the backbone's
columns (`full_state`): the files are a one-rank run's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import shutil
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional

import torch

from mucon_tpu_torch.config.support import check_supported
from mucon_tpu_torch.data import PaddedBatchLoader
from mucon_tpu_torch.harness.cache import CacheBudget, arrays_nbytes
from mucon_tpu_torch.harness.checkpoint import has_checkpoint, load_checkpoint, save_checkpoint
from mucon_tpu_torch.harness.logging import RunLogger, StepTimer
from mucon_tpu_torch.harness.metrics_store import MetricStore
from mucon_tpu_torch.harness.optim import (
    clip_gradients,
    create_optimizer,
    create_scheduler,
    local_norm_sq,
    set_learning_rate,
)
from mucon_tpu_torch.models.model import MuConModel, batch_to_host_tensors, resolve_feats_dtype
from mucon_tpu_torch.models.routing import routes_from_cfg
from mucon_tpu_torch.parallel.mesh import (
    apply_gradients,
    broadcast_module,
    data_rank,
    full_state,
    local_state,
    make_sharded_grad_step,
    make_sharded_train_step,
    mesh_shape,
    model_norm_sq,
    rank_rows,
    shard_params,
)
from mucon_tpu_torch.parallel.multihost import is_coordinator, run_mesh


@dataclasses.dataclass(frozen=True)
class ReplayBatch:
    """What a cache-replay epoch has of a batch in place of a
    `PaddedBatch`: its identity and size (trainer.py:47-55)."""

    video_names: tuple
    batch_size: int


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
        check_supported(cfg)
        if device is not None and torch.device(device).type != model.device.type:
            raise ValueError(f"the model lives on {model.device}, not on {device}")
        self.cfg = cfg
        self.exp_name = exp_name
        self.train_db = train_db
        self.model = model
        self.device = model.device
        self.evaluators = list(evaluators) if evaluators else []
        self.use_kernels = routes_from_cfg(cfg)
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
        # the mesh (trainer.py:167-221): its "model" axis splits the
        # backbone's leaves before the optimizer sees them
        self.mesh = run_mesh(cfg, self.device.type)
        self.n_data = 1
        norm_sq = local_norm_sq
        if self.mesh is not None:
            self.n_data = mesh_shape(self.mesh)["data"]
            if cfg.tpu.batch_size % self.n_data:
                raise ValueError(f"tpu.batch_size ({cfg.tpu.batch_size}) must be a multiple "
                                 f"of the mesh data axis ({self.n_data})")
            if mesh_shape(self.mesh)["model"] > 1:
                shard_params(self.mesh, model.net)
                norm_sq = model_norm_sq(model.net, self.mesh)
            broadcast_module(model.net, self.mesh)
        tr = cfg.trainer
        self.optimizer = create_optimizer(model.net.parameters(), tr.optimizer,
                                          tr.learning_rate, tr.momentum, tr.weight_decay)
        self.scheduler = create_scheduler(cfg)
        self.accumulate_grad_every = max(1, int(tr.accumulate_grad_every or 1))
        self._loader = None
        self._save_thread = None
        self._copy_stream = None
        # the device batch cache and its byte budget, which the evaluators
        # share (trainer.py:138-147)
        self._batch_cache: Dict[tuple, dict] = {}
        self.cache_budget = CacheBudget.from_config(cfg)
        for ev in self.evaluators:
            if getattr(ev, "cache_budget", None) is None:
                ev.cache_budget = self.cache_budget
        # "auto": bf16 when the model computes in bf16 (trainer.py:148-152)
        self._feats_dtype = resolve_feats_dtype(cfg, auto_bf16=cfg.tpu.compute_dtype == "bfloat16")

        self._clip = lambda: clip_gradients(self.cfg.trainer, self.partition, norm_sq)
        self._train_step = make_sharded_train_step(model, self.optimizer, self.mesh,
                                                   use_kernels=self.use_kernels, clip=self._clip)
        self._grad_steps: Dict[int, object] = {}  # make_sharded_grad_step by k

    def create_train_dataloader(self) -> PaddedBatchLoader:
        if self._loader is None:
            self._loader = PaddedBatchLoader(
                self.train_db, batch_size=max(1, self.cfg.tpu.batch_size),
                pad_multiple=self.cfg.tpu.pad_multiple, shuffle=True, seed=self.seed,
                prefetch=max(1, self.cfg.system.num_workers),
                fixed_batches=bool(self.cfg.tpu.cache_batches),
                batch_divisor=self.n_data,
            )
        return self._loader

    # -- the data path -----------------------------------------------------
    def _make_arrays(self, batch, stream=None):
        """(device tensors of `batch` on the train wire, the event its copy
        records or None); under a mesh, of this rank's rows only
        (trainer.py:271-286).  With a side `stream` (the card): pinned host
        tensors copied `non_blocking` on it."""
        host = batch_to_host_tensors(batch, self.model.supervised, self._feats_dtype)
        if self.mesh is not None:
            host = rank_rows(self.mesh, host)
        if stream is None:
            return {k: v.to(self.device) for k, v in host.items()}, None
        with torch.cuda.stream(stream):
            arrays = {k: v.pin_memory().to(self.device, non_blocking=True)
                      for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record(stream)
        return arrays, ready

    def _batch_arrays(self, batch, stream=None):
        """`_make_arrays`, or with `tpu.cache_batches` the cached tensors of
        the batch; a new batch is cached if the budget has room."""
        if not self.cfg.tpu.cache_batches:
            return self._make_arrays(batch, stream)
        key = tuple(batch.video_names)
        arrays = self._batch_cache.get(key)
        if arrays is not None:
            return arrays, None
        arrays, ready = self._make_arrays(batch, stream)
        if self.cache_budget.try_reserve(arrays_nbytes(arrays), "train batch"):
            self._batch_cache[key] = arrays
        return arrays, ready

    def _prefetched(self, loader):
        """(batch, tensors, event) with each copy issued
        `tpu.device_prefetch` batches ahead of the step that reads it
        (trainer.py:303-321)."""
        ahead = max(0, int(self.cfg.tpu.device_prefetch))
        stream = None
        if ahead and self.device.type == "cuda":
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            stream = self._copy_stream
        buf: deque = deque()
        for batch in loader:
            buf.append((batch, *self._batch_arrays(batch, stream)))
            if len(buf) > ahead:
                yield buf.popleft()
        while buf:
            yield buf.popleft()

    def _epoch_batches(self, loader):
        """One epoch's (batch, tensors, event) triples.  Once every fixed
        batch is cached, replay the cache in the loader's own order for the
        epoch, touching no dataset (trainer.py:323-349); if a batch of the
        plan is missing the loader's epoch is rewound and it streams the
        same order."""
        if (self.cfg.tpu.cache_batches and loader.fixed_batches and len(loader) > 0
                and len(self._batch_cache) >= len(loader)):
            epoch_before = loader.epoch
            replay = []
            for key, size in loader.iter_cached_keys():
                arrays = self._batch_cache.get(key)
                if arrays is None:  # the composition changed: stream
                    replay = None
                    break
                replay.append((ReplayBatch(key, size), arrays, None))
            if replay is not None:
                return iter(replay)
            loader.epoch = epoch_before
        return self._prefetched(loader)

    def _wait_for(self, arrays: dict, ready) -> None:
        """Make the compute stream wait for a batch copied on the side
        stream, and tie its tensors to the compute stream for the caching
        allocator."""
        if ready is None:
            return
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(ready)
        for t in arrays.values():
            t.record_stream(compute)

    def step_generator(self) -> torch.Generator:
        """This iteration's mask generator, seeded from (seed, iteration)
        and, on data rank r > 0, r (mesh.py:164 folds the data index into
        the step's key): the replicas draw different masks, and data rank 0
        the single-card run's.  The "seq" and "model" ranks of a data row
        draw the same masks (each slices its block and columns)."""
        seed = self.seed * 1_000_003 + self.iter_num + data_rank(self.mesh) * 0x9E3779B97F4A7C15
        return torch.Generator(device=self.device).manual_seed(seed % 2**64)

    def train_step(self, arrays: dict) -> Dict[str, torch.Tensor]:
        """forward -> loss -> backward -> (all-reduce) -> clip -> optimizer
        step (trainer.py:397-409), teacher-forced as the model's flag says.
        Returns the loss terms (detached, on the device: reading them
        syncs)."""
        return self._train_step(arrays, self.step_generator())

    def _backward(self, arrays: dict, k: int) -> Dict[str, torch.Tensor]:
        """forward -> loss -> backward of loss / k into the parameters'
        summed gradients (trainer.py:425-435); returns the loss terms."""
        if k not in self._grad_steps:
            self._grad_steps[k] = make_sharded_grad_step(
                self.model, self.mesh, accumulate_grad_every=k, use_kernels=self.use_kernels)
        return self._grad_steps[k](arrays, self.step_generator())

    def _apply(self) -> None:
        """Apply the summed gradients (`parallel/mesh.py apply_gradients`:
        zero fill, the all-reduce under a mesh, the clip, the optimizer
        step) and zero them."""
        apply_gradients(self.model.net, self.optimizer, self.mesh, self._clip)

    def figure_scheduler_input(self, eval_results) -> dict:
        if self.cfg.trainer.scheduler.name == "plateau" and eval_results:
            return {"metrics": eval_results[0].s_mof_nbg}
        return {}

    def on_start_epoch(self, epoch_num: int) -> None:
        """Teacher forcing as `model.teacher_forcing` says (trainer.py:357-358)."""
        self.model.set_teacher_forcing(self.cfg.model.teacher_forcing)

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
            with self._phase("callbacks"):
                self.on_start_epoch(epoch)
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
                # the evaluators switch teacher forcing; restore it for training
                self.model.set_teacher_forcing(self.cfg.model.teacher_forcing)

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
        every = self.accumulate_grad_every
        batches = self._epoch_batches(self.create_train_dataloader())
        for it, (batch, arrays, ready) in enumerate(batches):
            self._wait_for(arrays, ready)
            scalars = self._backward(arrays, every)
            if it % every == every - 1:
                self._apply()
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
        # a partial accumulation is dropped, as the JAX trainer starts each
        # epoch from zero gradients
        self.optimizer.zero_grad(set_to_none=True)
        if last is not None:  # one sync: the epoch's last loss terms
            self.logger.log("epoch", self.epoch_num, **{k: float(v) for k, v in last.items()},
                            epoch_seconds=time.perf_counter() - t0)

    # -- checkpointing -----------------------------------------------------
    def _get_checkpointing_folder(self) -> Path:
        """This epoch's checkpoint folder, made on the coordinator only."""
        folder = self.run_folder / "checkpoints" / f"epoch_{self.epoch_num}"
        if is_coordinator():
            folder.mkdir(parents=True, exist_ok=True)
        return folder

    def save_training(self) -> None:
        """Checkpoint the run; only the coordinator writes (trainer.py:
        609-619): the replicas' weights are equal.  With the backbone split
        over "model", every rank first joins the all-gather of its columns
        of the parameters and the optimizer state (`full_state`), so the
        files hold whole leaves, as a one-rank run's do."""
        model_state, opt_state = full_state(self.model.net, self.optimizer, self.mesh)
        if not is_coordinator():
            return
        state = {
            "epoch_num": self.epoch_num,
            "iter_num": self.iter_num,
            "scheduler": self.scheduler.state_dict() if self.scheduler else None,
        }
        self.wait_for_save()  # one writer at a time
        self._save_thread = save_checkpoint(
            self._get_checkpointing_folder(), model_state, opt_state, state,
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
        from <root>/<exp>/<run>/checkpoints/epoch_<epoch>/.  Under a mesh
        every rank reads that folder (the coordinator's, which
        `trainer.root` names), each keeps its columns of the backbone's
        leaves (`local_state`, bit for bit), and the weights are then
        broadcast from data rank 0, so the replicas stay equal."""
        folder = self.root / self.exp_name / str(run) / "checkpoints" / f"epoch_{epoch}"
        model_state, opt_state, state = load_checkpoint(folder, self.device)
        model_state, opt_state = local_state(self.model.net, model_state, opt_state, self.mesh)
        self.model.net.load_state_dict(model_state, strict=True)
        if self.mesh is not None:
            broadcast_module(self.model.net, self.mesh)
        if opt_state is not None:
            self.optimizer.load_state_dict(opt_state)
        self.epoch_num = state.get("epoch_num", epoch)
        self.iter_num = state.get("iter_num", 0)
        if self.scheduler is not None and state.get("scheduler"):
            self.scheduler.load_state_dict(state["scheduler"])
            set_learning_rate(self.optimizer, self.scheduler.lr)


class TrainerForTFExperiments(SimpleTrainer):
    """Teacher forcing on up to `turnoff_tf_after_epoch`, then free decoding
    (trainer.py:716-724, the reference's trainers.py:166-191)."""

    def __init__(self, *args, turnoff_tf_after_epoch: int = 1000, **kwargs):
        super().__init__(*args, **kwargs)
        self.turnoff_tf_after_epoch = turnoff_tf_after_epoch

    def on_start_epoch(self, epoch_num: int) -> None:
        self.model.set_teacher_forcing(epoch_num < self.turnoff_tf_after_epoch)
