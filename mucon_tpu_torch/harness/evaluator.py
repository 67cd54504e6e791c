"""Evaluation: the 24-field MuCon result with Viterbi decoding
(mucon_tpu/harness/evaluator.py).

Reference semantics (src/mucon/evaluators.py):

* free decoding (`MuConAlignmentEvaluator`: teacher forcing, the action
  alignment task);
* transcript metrics on the s-head transcript (EOS dropped);
* Viterbi decode of the y-head log-softmax constrained to the s-head's own
  transcript, with a per-class Poisson length model whose means are the
  s-head's predicted lengths averaged per class;
* s-head framewise prediction by repeating the transcript with rounded
  relative lengths;
* all predictions nearest-interpolated to the GT length, then fed to the
  18 segmentation + 2 transcript + 6 edit/F1 metric objects;
* per-video raw outputs pickled for offline visualization (`save_stuff`).

Two paths, as in the JAX package, both under `torch.inference_mode()` on
the model's device (with the CUDA kernels of the stack, the BiLSTM, the
decoder chain under teacher forcing and the Viterbi DP + walk when the
model is on the card, each as its route says: `models/routing.py
routes_from_cfg`, from the `tpu.use_pallas*` flags):

* fused (`evaluator.viterbi.backend="device"`, `multi_length=False`):
  each batch runs `ops/eval_fused.py build_fused_eval`, whose Viterbi
  tables come from the pre-upsample log-probs; the host turns the window
  positions into labels and updates the numpy metrics.  With
  `tpu.eval_single_shape` every batch has one (batch_size, T_max) shape:
  the remainder batch gets dummy rows, which are sliced off.
* per batch (`backend="host"` or `multi_length=True`; evaluator.py:324-341,
  675-802): the forward, then `MuConModel.predict` on the host, and the
  Viterbi decode of the full-T log-probs either on the device
  (`ops/viterbi.py dense_viterbi_decode_batch`: the DP kernel with its
  pointer walk) or, with `backend="host"`, by the numpy hypothesis DP
  (`decode/viterbi_host.py`), one video at a time.

The data path (evaluator.py:375-417, 443-515): the features travel on the
wire `tpu.eval_feats_transfer_dtype` names (`models/model.py
resolve_feats_dtype`).  With `tpu.cache_batches` each (fixed) eval batch's
device tensors stay cached in the `eval` pool of a `harness/cache.py`
budget, the trainer's when a trainer holds the evaluator, else its own;
after one pass in which every batch was cached, later evaluations replay
(batch without its features, device tensors) pairs and read, collate and
copy nothing.  A batch the budget refuses leaves the evaluator streaming.

Under a mesh (evaluator.py:255-441, the trainer's rule: `tpu.mesh.enable`
and either `tpu.mesh.multihost` or more than one rank) the fused path runs
data-parallel: each batch is padded to a multiple of the data axis (to
`tpu.batch_size` under `tpu.eval_single_shape`), each rank runs the fused
program, kernels included, on its own rows, and the fixed-shape outputs
are gathered from every rank in rank order before they go to the host.
With "seq" or "model" above 1 (evaluator.py:520-545) each rank also holds
its time block, the backbone runs sharded and is gathered to the data
rank's rows (`MuConModel.forward`), and the BiLSTM and Viterbi kernels run
on those rows as on one card.
Every rank then consumes every video and computes the same 24 fields (the
JAX package's replicated consume), and only the coordinator writes the
pickle.  A run of several processes without the mesh, or on the per-batch
path, raises.
"""

from __future__ import annotations

import dataclasses
import pickle
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from mucon_tpu_torch.config.support import check_supported
from mucon_tpu_torch.data.batching import PaddedBatch, PaddedBatchLoader
from mucon_tpu_torch.decode.grammar import SingleTranscriptGrammar
from mucon_tpu_torch.decode.length_model import PoissonModel
from mucon_tpu_torch.decode.viterbi_host import ViterbiDecoder
from mucon_tpu_torch.harness.cache import CacheBudget, arrays_nbytes
from mucon_tpu_torch.metrics import (
    AbsLenDiffMetric,
    Edit,
    F1Score,
    IoDMetric,
    IoUMetric,
    MatchingScoreMetric,
    Metric,
    MoFAccuracyMetric,
)
from mucon_tpu_torch.models.model import (
    batch_to_host_tensors,
    eval_feats_round_to_bf16,
    resolve_feats_dtype,
)
from mucon_tpu_torch.models.routing import routes_from_cfg
from mucon_tpu_torch.ops.eval_fused import build_fused_eval
from mucon_tpu_torch.ops.viterbi import dense_viterbi_decode_batch, positions_to_results
from mucon_tpu_torch.parallel.mesh import mesh_shape, pad_rows, shard_batch_arrays, shard_params
from mucon_tpu_torch.parallel.multihost import is_coordinator, run_mesh, world_size
from mucon_tpu_torch.utils import make_same_size_interpolate


def create_segmentation_from_segments(actions: np.ndarray, lengths: np.ndarray,
                                      n_frames: int) -> np.ndarray:
    """Expand (transcript, relative lengths) to frames (evaluators.py:28-35)."""
    lengths = lengths * n_frames
    lengths = np.around(lengths).astype(int)
    lengths[lengths < 0] = 0
    return np.repeat(actions, lengths)


def one_hot(a: np.ndarray, num_classes: int) -> np.ndarray:
    return np.eye(num_classes)[a.reshape(-1)]


@dataclass
class MuConEvaluatorResult:
    """24 metric fields (reference evaluators.py:38-67)."""

    y_mof: float
    y_mof_nbg: float
    y_iod: float
    y_iou: float

    s_mof: float
    s_mof_nbg: float
    s_iod: float
    s_iou: float
    s_iod_nbg: float
    s_iou_nbg: float

    s_mat_score: float
    s_len_diff: float

    vit_mof: float
    vit_mof_nbg: float
    vit_iod: float
    vit_iou: float
    vit_iod_nbg: float
    vit_iou_nbg: float

    vit_edit_score: float
    vit_f1_score: Tuple[float, float, float]
    y_edit_score: float
    y_f1_score: Tuple[float, float, float]
    s_edit_score: float
    s_f1_score: Tuple[float, float, float]


class MuConEvaluator:
    def __init__(self, cfg, test_db, model, device=None):
        check_supported(cfg)
        if device is not None and torch.device(device).type != model.device.type:
            raise ValueError(f"the model lives on {model.device}, not on {device}")
        self.cfg = cfg
        self.test_db = test_db
        self.model = model
        self.use_kernels = routes_from_cfg(cfg)
        self.name = "eval"
        self.checkpointing_folder: Optional[Path] = None
        self.enable_viterbi = False
        self.viterbi_multi_length = cfg.evaluator.viterbi.multi_length
        self.frame_sampling = cfg.evaluator.viterbi.frame_sampling
        self.viterbi_backend = cfg.evaluator.viterbi.backend
        if self.viterbi_backend not in ("device", "host"):
            raise ValueError(f"Invalid evaluator.viterbi.backend {self.viterbi_backend!r}")
        self.last_eval_phases: dict = {}
        # "auto": bf16 when the forward rounds the features to bf16 first
        self._feats_dtype = resolve_feats_dtype(
            cfg, "eval_feats_transfer_dtype", eval_feats_round_to_bf16(cfg, self.use_kernels))
        self.cache_budget: Optional[CacheBudget] = None  # a trainer shares its own
        self._array_cache: dict = {}
        self._replay: Optional[list] = None
        self._mesh = None
        self._mesh_built = False

        bg = test_db.background_class_ids
        self.y_mof_metric = MoFAccuracyMetric()
        self.y_mof_nbg_metric = MoFAccuracyMetric(ignore_ids=bg)
        self.y_iod_metric = IoDMetric()
        self.y_iou_metric = IoUMetric()

        self.s_mof_metric = MoFAccuracyMetric()
        self.s_mof_nbg_metric = MoFAccuracyMetric(ignore_ids=bg)
        self.s_iod_metric = IoDMetric()
        self.s_iou_metric = IoUMetric()
        self.s_iod_nbg_metric = IoDMetric(ignore_ids=bg)
        self.s_iou_nbg_metric = IoUMetric(ignore_ids=bg)

        self.vit_mof_metric = MoFAccuracyMetric()
        self.vit_mof_nbg_metric = MoFAccuracyMetric(ignore_ids=bg)
        self.vit_iod_metric = IoDMetric()
        self.vit_iou_metric = IoUMetric()
        self.vit_iod_nbg_metric = IoDMetric(ignore_ids=bg)
        self.vit_iou_nbg_metric = IoUMetric(ignore_ids=bg)

        self.s_mat_score_metric = MatchingScoreMetric()
        self.s_abs_len_diff_metric = AbsLenDiffMetric()

        self.vit_edit_score_metric = Edit()
        self.y_edit_score_metric = Edit()
        self.s_edit_score_metric = Edit()
        self.vit_f1_score_metric = F1Score()
        self.y_f1_score_metric = F1Score()
        self.s_f1_score_metric = F1Score()

    def viterbi_mode(self, mode: bool = True) -> None:
        self.enable_viterbi = mode

    def get_name(self) -> str:
        return self.name

    def set_name(self, name: str) -> None:
        self.name = name

    def set_checkpointing_folder(self, folder: Path) -> None:
        self.checkpointing_folder = Path(folder)

    def _fused_backend(self) -> bool:
        """Does `evaluate` run the fused path (evaluator.py:171)?"""
        return self.viterbi_backend == "device" and not self.viterbi_multi_length

    def _single_shape(self) -> bool:
        """tpu.eval_single_shape, which pads the fused path only
        (evaluator.py:177)."""
        return bool(self.cfg.tpu.eval_single_shape) and self._fused_backend()

    def _eval_pad_to(self) -> Optional[int]:
        """With `_single_shape`: one T_pad, the test set's longest video
        rounded up to pad_multiple (evaluator.py:192)."""
        if not self._single_shape():
            return None
        t_max = max(self.test_db.num_frames(i) for i in range(len(self.test_db)))
        pm = self.cfg.tpu.pad_multiple
        return int(-(-t_max // pm) * pm)

    def create_dataloader(self) -> PaddedBatchLoader:
        return PaddedBatchLoader(
            self.test_db, batch_size=max(1, self.cfg.tpu.batch_size),
            pad_multiple=self.cfg.tpu.pad_multiple, shuffle=False, prefetch=2,
            pad_to=self._eval_pad_to(),
        )

    def on_start_eval(self, model=None) -> None:
        """Free decoding (the alignment evaluator turns teacher forcing on),
        and empty metrics."""
        (self.model if model is None else model).set_teacher_forcing(False)
        self.y_segs, self.s_segs, self.vit_segs = [], [], []
        self.s_lens, self.s_transcript = [], []
        self.target_segs, self.target_transcripts = [], []
        for attr in vars(self).values():
            if isinstance(attr, Metric):
                attr.reset()

    def evaluate(self, model=None) -> MuConEvaluatorResult:
        """One pass over the test set with `model` (default: the one given
        at construction), on the fused path or per batch (module
        docstring).  `last_eval_phases` splits its wall time: stream (batch
        fetch, collate and the copy to the device), first_dispatch /
        dispatch (the first / the other batches' device work up to its
        outputs on the host: the fused program, or the forward), consume
        (tracebacks, the per-batch path's prediction and Viterbi decode, and
        metric updates) and finish (aggregation)."""
        model = self.model if model is None else model
        mesh = self._eval_mesh(model.device)
        if world_size() > 1 and not self._fused_backend():
            raise RuntimeError("a multi-process evaluation needs the fused device backend "
                               "(evaluator.viterbi.backend='device', multi_length=False): "
                               "the per-batch path decodes whole batches on one card")
        if world_size() > 1 and mesh is None:
            raise RuntimeError("a multi-process evaluation needs the mesh "
                               "(tpu.mesh.enable=True): each rank holds only its own rows")
        if mesh is not None and mesh_shape(mesh)["model"] > 1:
            # a net the trainer did not split keeps its columns from here on,
            # as the trainer's does (a net split alike is left as it is)
            shard_params(mesh, model.net)
        self.on_start_eval(model)
        ph = dict(stream=0.0, first_dispatch=0.0, dispatch=0.0, consume=0.0, finish=0.0)
        self.last_eval_phases = ph
        if self._fused_backend():
            # the program is keyed on teacher forcing (evaluator.py:518-521)
            run = build_fused_eval(model, teacher_forcing=model.teacher_forcing,
                                   frame_sampling=self.frame_sampling,
                                   use_kernels=self.use_kernels, mesh=mesh)
            consume = self._consume_fused
        else:
            def run(arrays):
                return model.forward(arrays, use_kernels=self.use_kernels,
                                     teacher_forcing=model.teacher_forcing)

            def consume(batch, fwd):
                self.batch_eval_calculation(batch, fwd, model)
        first = True
        with torch.inference_mode():
            batches = self._eval_batches(model.device)
            while True:
                t0 = time.perf_counter()
                nxt = next(batches, None)
                t1 = time.perf_counter()
                ph["stream"] += t1 - t0
                if nxt is None:
                    break
                batch, arrays = nxt
                out = run(arrays)
                t2 = time.perf_counter()
                ph["first_dispatch" if first else "dispatch"] += t2 - t1
                first = False
                consume(batch, out)
                ph["consume"] += time.perf_counter() - t2
        t0 = time.perf_counter()
        result = self.on_finish_eval()
        ph["finish"] = time.perf_counter() - t0
        return result

    def _eval_mesh(self, device):
        """The mesh of a data-parallel fused eval, or None (evaluator.py:
        376-397); built once, on first use."""
        if not self._fused_backend():
            return None
        if not self._mesh_built:
            self._mesh = run_mesh(self.cfg, torch.device(device).type)
            self._mesh_built = True
        return self._mesh

    def _make_arrays(self, batch: PaddedBatch, device) -> dict:
        """Device tensors of `batch` on the eval wire; with `_single_shape`
        the remainder batch padded with dummy rows (evaluator.py:383-401).
        Under a mesh the batch is padded to a multiple of the data axis
        (or to `tpu.batch_size` with `_single_shape`) and only this rank's
        rows are moved (evaluator.py:403-441)."""
        host = batch_to_host_tensors(batch, feats_dtype=self._feats_dtype)
        mesh = self._eval_mesh(device)
        rows = max(1, self.cfg.tpu.batch_size) if self._single_shape() else 0
        if mesh is None:
            return pad_rows({k: v.to(device) for k, v in host.items()}, rows)
        n_data = mesh_shape(mesh)["data"]
        rows = rows or -(-batch.batch_size // n_data) * n_data
        return shard_batch_arrays(mesh, pad_rows(host, rows), device)

    def _batch_arrays(self, batch: PaddedBatch, device) -> dict:
        """`_make_arrays`, kept across evaluations with `tpu.cache_batches`
        where the budget's eval pool has room (evaluator.py:490-515)."""
        if not self.cfg.tpu.cache_batches:
            return self._make_arrays(batch, device)
        key = tuple(batch.video_names)
        arrays = self._array_cache.get(key)
        if arrays is None:
            arrays = self._make_arrays(batch, device)
            if self.cache_budget is None:
                self.cache_budget = CacheBudget.from_config(self.cfg)
            if self.cache_budget.try_reserve(arrays_nbytes(arrays), "eval batch", pool="eval"):
                self._array_cache[key] = arrays
        return arrays

    def _eval_batches(self, device):
        """(batch, device tensors) pairs of one pass (evaluator.py:443-488).
        After a pass in which every batch was cached, replay that pass: each
        batch keeps its metadata and a `feats` of shape [B x T_pad x 0], so
        `feats.shape[1]` stays valid; the loops read no feature values."""
        if self._replay is not None:
            yield from self._replay
            return
        recording = [] if self.cfg.tpu.cache_batches else None
        for batch in self.create_dataloader():
            arrays = self._batch_arrays(batch, device)
            if recording is not None:
                if self._array_cache.get(tuple(batch.video_names)) is arrays:
                    B, T = batch.feats.shape[:2]
                    recording.append((dataclasses.replace(
                        batch, feats=np.empty((B, T, 0), np.float32)), arrays))
                else:  # a budget miss: no replay, it would skip this batch
                    recording = None
            yield batch, arrays
        if recording:
            self._replay = recording

    def _consume_fused(self, batch: PaddedBatch, out: dict) -> None:
        """Host half of one fused program (evaluator.py:552): tracebacks and
        metric updates for the batch's real videos."""
        B = batch.batch_size
        s_transcripts, s_rel_lengths = [], []
        for i in range(B):
            n = int(out["n_dec"][i])
            s_transcripts.append([int(x) for x in out["transcripts"][i, :n]])
            s_rel_lengths.append(out["rel_lengths"][i, :n])
        if self.enable_viterbi:
            vit_labels = [r.labels for r in positions_to_results(
                batch.num_frames[:B], out["transcripts"][:B], out["n_dec"][:B],
                out["vit_score"][:B], out["vit_pos"][:B], out["vit_k_valid"][:B],
                self.frame_sampling)]
        else:
            vit_labels = [None] * B
        self._feed_all_metrics(batch, out["y_argmax"], s_transcripts, s_rel_lengths, vit_labels)

    def _feed_all_metrics(self, batch, y_pred_full, s_transcripts, s_rel_lengths,
                          vit_labels) -> None:
        for i in range(batch.batch_size):
            t_i = int(batch.num_frames[i])
            n_i = int(batch.transcript_len[i])
            target_labels = np.asarray(batch.gt_label[i, :t_i])
            target_transcript = list(batch.transcript[i, :n_i])

            self.s_mat_score_metric.add(target_transcript=target_transcript,
                                        predicted_transcript=s_transcripts[i])
            self.s_abs_len_diff_metric.add(target_transcript=target_transcript,
                                           predicted_transcript=s_transcripts[i])

            y_pred = np.asarray(y_pred_full[i][:t_i])
            s_pred = create_segmentation_from_segments(
                actions=np.asarray(s_transcripts[i], dtype=np.int64),
                lengths=np.asarray(s_rel_lengths[i])[: len(s_transcripts[i])],
                n_frames=t_i,
            )
            if s_pred.size == 0:
                s_pred = np.zeros(t_i, np.int64)

            s_same = make_same_size_interpolate(s_pred, target_labels)
            y_same = make_same_size_interpolate(y_pred, target_labels)

            for m in (self.s_mof_metric, self.s_mof_nbg_metric, self.s_iod_metric,
                      self.s_iod_nbg_metric, self.s_iou_metric, self.s_iou_nbg_metric,
                      self.s_edit_score_metric, self.s_f1_score_metric):
                m(targets=target_labels, predictions=s_same)
            for m in (self.y_mof_metric, self.y_mof_nbg_metric, self.y_iod_metric,
                      self.y_iou_metric, self.y_edit_score_metric, self.y_f1_score_metric):
                m(targets=target_labels, predictions=y_same)

            if self.enable_viterbi and vit_labels[i] is not None:
                vit_same = make_same_size_interpolate(vit_labels[i], target_labels)
                for m in (self.vit_mof_metric, self.vit_mof_nbg_metric, self.vit_iod_metric,
                          self.vit_iod_nbg_metric, self.vit_iou_metric,
                          self.vit_iou_nbg_metric, self.vit_edit_score_metric,
                          self.vit_f1_score_metric):
                    m(targets=target_labels, predictions=vit_same)
                self.vit_segs.append(vit_same)
            else:
                self.vit_segs.append(s_same)

            self.y_segs.append(y_same)
            self.s_segs.append(s_same)
            self.s_lens.append(np.asarray(s_rel_lengths[i]))
            self.s_transcript.append(s_transcripts[i])
            self.target_segs.append(target_labels)
            self.target_transcripts.append(target_transcript)

    def batch_eval_calculation(self, batch: PaddedBatch, fwd, model=None) -> None:
        """The per-batch path's host half (evaluator.py:675-748): the
        model's per-video predictions (EOS dropped from the transcript),
        the Viterbi decode of the full-T log-probs, and metric updates."""
        model = self.model if model is None else model
        preds = model.predict(batch, fwd)
        s_transcripts = [p.transcript[:-1] for p in preds]
        s_rel_lengths = [np.asarray(p.lengths) for p in preds]
        vit_labels = [None] * batch.batch_size
        if self.enable_viterbi:
            vit_labels = self._decode_viterbi_batch(
                batch, preds, s_transcripts, s_rel_lengths, self.test_db.get_num_classes(),
                model.device)
        y_preds = [np.argmax(p.segmentation_logits, axis=1) for p in preds]
        self._feed_all_metrics(batch, y_preds, s_transcripts, s_rel_lengths, vit_labels)

    def _decode_viterbi_batch(self, batch, preds, s_transcripts, s_rel_lengths, M: int,
                              device) -> List[np.ndarray]:
        """Per-class Poisson means from the s-head (evaluators.py:152-168),
        then the dense decode on `device`, or the host oracle when
        `evaluator.viterbi.backend="host"` (evaluator.py:750-802)."""
        B = batch.batch_size
        all_lambdas = np.ones((B, M), np.float64)
        transcripts, n_valid = [], []
        n_max = max(1, max(len(t) for t in s_transcripts))
        for i in range(B):
            tr = [t for t in s_transcripts[i] if 0 <= t < M]
            rel = s_rel_lengths[i][: len(tr)]
            if not tr:
                # degenerate (EOS first): decode against background only, one
                # segment of the whole video, as the fused path does.  The
                # JAX package raises here (np.dot of no lengths): ROADMAP
                # queue 3, F6
                tr, rel = [0], np.ones(1, np.float32)
            t_i = int(batch.num_frames[i])
            actions = one_hot(np.array(tr), M)
            lam = np.dot(rel, actions) * t_i
            k = actions.sum(0)
            k[k == 0] = 1
            lam /= k
            lam[lam == 0] = 1
            all_lambdas[i] = lam
            transcripts.append(tr + [0] * (n_max - len(tr)))
            n_valid.append(len(tr))

        if self.viterbi_backend == "host":
            out = []
            for i in range(B):
                decoder = ViterbiDecoder(SingleTranscriptGrammar(transcripts[i][: n_valid[i]], M),
                                         PoissonModel(all_lambdas[i]), self.frame_sampling)
                _, labels, _ = decoder.decode(preds[i].segmentation_logits.astype(np.float64))
                out.append(np.asarray(labels))
            return out

        t_pad = int(batch.feats.shape[1])
        log_probs = np.zeros((B, t_pad, M), np.float32)
        for i in range(B):
            log_probs[i, : int(batch.num_frames[i])] = preds[i].segmentation_logits
        results = dense_viterbi_decode_batch(
            log_probs, batch.num_frames, np.asarray(transcripts, np.int32),
            np.asarray(n_valid, np.int32), all_lambdas.astype(np.float32),
            frame_sampling=self.frame_sampling, device=device,
            use_kernels=self.use_kernels.viterbi)
        return [r.labels for r in results]

    def on_finish_eval(self) -> MuConEvaluatorResult:
        self.to_save = {
            "y_segs": self.y_segs,
            "s_segs": self.s_segs,
            "vit_segs": self.vit_segs,
            "s_lens": self.s_lens,
            "s_transcript": self.s_transcript,
            "target_segs": self.target_segs,
            "target_transcripts": self.target_transcripts,
        }
        return MuConEvaluatorResult(
            s_mat_score=self.s_mat_score_metric.summary(),
            s_len_diff=self.s_abs_len_diff_metric.summary(),
            s_mof=self.s_mof_metric.summary(),
            s_mof_nbg=self.s_mof_nbg_metric.summary(),
            s_iod=self.s_iod_metric.summary(),
            s_iod_nbg=self.s_iod_nbg_metric.summary(),
            s_iou=self.s_iou_metric.summary(),
            s_iou_nbg=self.s_iou_nbg_metric.summary(),
            y_mof=self.y_mof_metric.summary(),
            y_mof_nbg=self.y_mof_nbg_metric.summary(),
            y_iod=self.y_iod_metric.summary(),
            y_iou=self.y_iou_metric.summary(),
            vit_mof=self.vit_mof_metric.summary(),
            vit_mof_nbg=self.vit_mof_nbg_metric.summary(),
            vit_iod=self.vit_iod_metric.summary(),
            vit_iod_nbg=self.vit_iod_nbg_metric.summary(),
            vit_iou=self.vit_iou_metric.summary(),
            vit_iou_nbg=self.vit_iou_nbg_metric.summary(),
            y_edit_score=self.y_edit_score_metric.summary(),
            y_f1_score=tuple(self.y_f1_score_metric.summary()),
            s_edit_score=self.s_edit_score_metric.summary(),
            s_f1_score=tuple(self.s_f1_score_metric.summary()),
            vit_edit_score=self.vit_edit_score_metric.summary(),
            vit_f1_score=tuple(self.vit_f1_score_metric.summary()),
        )

    def save_stuff(self) -> None:
        """Pickle the last pass's per-video outputs to
        <checkpointing folder>/data_<name>.pkl; in a run of several
        processes, on the coordinator only (evaluator.py:841-852)."""
        if self.checkpointing_folder is None:
            raise RuntimeError("save_stuff needs set_checkpointing_folder first")
        if not is_coordinator():  # every rank holds the same outputs
            return
        self.checkpointing_folder.mkdir(parents=True, exist_ok=True)
        with open(self.checkpointing_folder / f"data_{self.name}.pkl", "wb") as f:
            pickle.dump(self.to_save, f)


class MuConAlignmentEvaluator(MuConEvaluator):
    """Action alignment: decode with the ground-truth transcript (teacher
    forcing), the reference's evaluators.py:343-347 (evaluator.py:858)."""

    def on_start_eval(self, model=None) -> None:
        super().on_start_eval(model)
        (self.model if model is None else model).set_teacher_forcing(True)
