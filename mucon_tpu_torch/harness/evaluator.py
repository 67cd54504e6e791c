"""Evaluation: the 24-field MuCon result with Viterbi decoding
(mucon_tpu/harness/evaluator.py, its fused device path).

Reference semantics (src/mucon/evaluators.py):

* free decoding;
* transcript metrics on the s-head transcript (EOS dropped);
* Viterbi decode of the y-head log-softmax constrained to the s-head's own
  transcript, with a per-class Poisson length model whose means are the
  s-head's predicted lengths averaged per class;
* s-head framewise prediction by repeating the transcript with rounded
  relative lengths;
* all predictions nearest-interpolated to the GT length, then fed to the
  18 segmentation + 2 transcript + 6 edit/F1 metric objects;
* per-video raw outputs pickled for offline visualization (`save_stuff`).

Each batch runs `ops/eval_fused.py build_fused_eval` on the model's device
(with the CUDA kernels of the stack, the BiLSTM and the Viterbi DP + walk
when the model is on the card and `use_kernels_from_cfg` says so), under
`torch.inference_mode()`; the host turns the window positions into labels
and updates the numpy metrics.  With `tpu.eval_single_shape` every batch
has one (batch_size, T_max) shape: the remainder batch gets dummy rows,
which are sliced off.  The host Viterbi backend, multi-length decoding and
the alignment evaluator are not ported (`config/support.py` refuses them).
"""

from __future__ import annotations

import pickle
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from mucon_tpu_torch.config.support import check_supported, use_kernels_from_cfg
from mucon_tpu_torch.data.batching import PaddedBatch, PaddedBatchLoader
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
from mucon_tpu_torch.models.model import batch_to_tensors
from mucon_tpu_torch.ops.eval_fused import build_fused_eval
from mucon_tpu_torch.ops.viterbi import positions_to_results
from mucon_tpu_torch.utils import make_same_size_interpolate


def create_segmentation_from_segments(actions: np.ndarray, lengths: np.ndarray,
                                      n_frames: int) -> np.ndarray:
    """Expand (transcript, relative lengths) to frames (evaluators.py:28-35)."""
    lengths = lengths * n_frames
    lengths = np.around(lengths).astype(int)
    lengths[lengths < 0] = 0
    return np.repeat(actions, lengths)


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


def pad_rows(arrays: dict, rows: int) -> dict:
    """Pad the batch axis to `rows` with dummy videos of 16 frames and a
    transcript of one (mucon_tpu/parallel/mesh.py pad_batch_to_multiple)."""
    b = arrays["num_frames"].shape[0]
    if b >= rows:
        return arrays
    out = {k: torch.cat([v, v.new_zeros((rows - b, *v.shape[1:]))]) for k, v in arrays.items()}
    out["num_frames"][b:] = 16
    out["transcript_len"][b:] = 1
    return out


class MuConEvaluator:
    def __init__(self, cfg, test_db, model, device=None):
        check_supported(cfg)
        if device is not None and torch.device(device).type != model.device.type:
            raise ValueError(f"the model lives on {model.device}, not on {device}")
        self.cfg = cfg
        self.test_db = test_db
        self.model = model
        self.use_kernels = use_kernels_from_cfg(cfg)
        self.name = "eval"
        self.checkpointing_folder: Optional[Path] = None
        self.enable_viterbi = False
        self.frame_sampling = cfg.evaluator.viterbi.frame_sampling
        self.last_eval_phases: dict = {}

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

    def _eval_pad_to(self) -> Optional[int]:
        """tpu.eval_single_shape: one T_pad, the test set's longest video
        rounded up to pad_multiple (evaluator.py:192)."""
        if not self.cfg.tpu.eval_single_shape:
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

    def on_start_eval(self) -> None:
        self.y_segs, self.s_segs, self.vit_segs = [], [], []
        self.s_lens, self.s_transcript = [], []
        self.target_segs, self.target_transcripts = [], []
        for attr in vars(self).values():
            if isinstance(attr, Metric):
                attr.reset()

    def evaluate(self, model=None) -> MuConEvaluatorResult:
        """One pass over the test set with `model` (default: the one given
        at construction).  `last_eval_phases` splits its wall time: stream
        (batch fetch, collate and the copy to the device), first_dispatch /
        dispatch (the fused program of the first / the other batches, up to
        its outputs on the host), consume (tracebacks and metric updates)
        and finish (aggregation)."""
        model = self.model if model is None else model
        self.on_start_eval()
        ph = dict(stream=0.0, first_dispatch=0.0, dispatch=0.0, consume=0.0, finish=0.0)
        self.last_eval_phases = ph
        run = build_fused_eval(model, teacher_forcing=False, frame_sampling=self.frame_sampling,
                               use_kernels=self.use_kernels)
        rows = max(1, self.cfg.tpu.batch_size) if self.cfg.tpu.eval_single_shape else 0
        first = True
        with torch.inference_mode():
            batches = iter(self.create_dataloader())
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    ph["stream"] += time.perf_counter() - t0
                    break
                arrays = pad_rows(batch_to_tensors(batch, model.device), rows)
                t1 = time.perf_counter()
                ph["stream"] += t1 - t0
                out = run(arrays)
                t2 = time.perf_counter()
                ph["first_dispatch" if first else "dispatch"] += t2 - t1
                first = False
                self._consume_fused(batch, out)
                ph["consume"] += time.perf_counter() - t2
        t0 = time.perf_counter()
        result = self.on_finish_eval()
        ph["finish"] = time.perf_counter() - t0
        return result

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
        <checkpointing folder>/data_<name>.pkl."""
        if self.checkpointing_folder is None:
            raise RuntimeError("save_stuff needs set_checkpointing_folder first")
        self.checkpointing_folder.mkdir(parents=True, exist_ok=True)
        with open(self.checkpointing_folder / f"data_{self.name}.pkl", "wb") as f:
            pickle.dump(self.to_save, f)
