"""Edit score and segmental F1@k — MS-TCN evaluation semantics
(mucon_tpu/metrics/fully_supervised.py).  The distances, edit scores and
F1 counts run in the native kernels where they load
(`mucon_tpu_torch/native`), else in the numpy path below.

Pinned to the behavior of the MS-TCN eval protocol as used by the reference
(src/core/metrics/{fully_supervised,mstcn_code}.py): segments are extracted
from framewise labels (background classes droppable), the edit score is the
normalized Levenshtein distance between segment-label sequences (x100), and
F1@k counts a predicted segment as a true positive when its IoU against the
best unmatched same-label GT segment reaches the overlap threshold.
"""

from typing import Iterable, List, Sequence, Tuple

import numpy as np

from mucon_tpu_torch import native
from mucon_tpu_torch.metrics.base import Metric


def labels_and_spans(
    framewise: Sequence[int], bg_class: Iterable[int] = ()
) -> Tuple[List[int], List[int], List[int]]:
    """Segment labels with [start, end) spans, skipping background runs."""
    bg = set(bg_class)
    labels, starts, ends = [], [], []
    prev = None
    for i, lab in enumerate(framewise):
        if lab != prev:
            if prev is not None and prev not in bg:
                ends.append(i)
            if lab not in bg:
                labels.append(lab)
                starts.append(i)
            prev = lab
    if prev is not None and prev not in bg:
        ends.append(len(framewise))
    return labels, starts, ends


def levenshtein(a: Sequence, b: Sequence, norm: bool = False) -> float:
    """Unit-cost edit distance; norm -> (1 - d/max_len) * 100.  The native
    kernel computes d when it is loaded."""
    la, lb = len(a), len(b)
    d = native.levenshtein_native(a, b)
    if d is not None:
        if norm:
            return (1.0 - d / max(la, lb)) * 100.0 if max(la, lb) > 0 else 100.0
        return float(d)
    prev = np.arange(lb + 1, dtype=np.float64)
    for i in range(1, la + 1):
        cur = np.empty(lb + 1)
        cur[0] = i
        for j in range(1, lb + 1):
            sub = prev[j - 1] + (0 if a[i - 1] == b[j - 1] else 1)
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub)
        prev = cur
    d = prev[lb]
    if norm:
        return (1.0 - d / max(la, lb)) * 100.0 if max(la, lb) > 0 else 100.0
    return float(d)


def edit_score(
    recognized, ground_truth, norm: bool = True, bg_class: Iterable[int] = ()
) -> float:
    p, _, _ = labels_and_spans(recognized, bg_class)
    y, _, _ = labels_and_spans(ground_truth, bg_class)
    return levenshtein(p, y, norm)


def f_score(
    recognized, ground_truth, overlap: float, bg_class: Iterable[int] = ()
) -> Tuple[float, float, float]:
    """(tp, fp, fn) at one IoU threshold, greedy best-match per prediction."""
    p_lab, p_start, p_end = labels_and_spans(recognized, bg_class)
    y_lab, y_start, y_end = labels_and_spans(ground_truth, bg_class)
    y_start_a, y_end_a = np.asarray(y_start), np.asarray(y_end)

    tp = fp = 0
    hits = np.zeros(len(y_lab))
    for j in range(len(p_lab)):
        inter = np.minimum(p_end[j], y_end_a) - np.maximum(p_start[j], y_start_a)
        union = np.maximum(p_end[j], y_end_a) - np.minimum(p_start[j], y_start_a)
        same = np.array([p_lab[j] == yl for yl in y_lab], dtype=np.float64)
        iou = (inter / union) * same
        idx = int(np.argmax(iou)) if len(iou) else 0
        if len(iou) and iou[idx] >= overlap and not hits[idx]:
            tp += 1
            hits[idx] = 1
        else:
            fp += 1
    fn = len(y_lab) - hits.sum()
    return float(tp), float(fp), float(fn)


class Edit(Metric):
    def __init__(self, ignore_ids: Iterable[int] = ()):
        self.ignore_ids = ignore_ids
        self.reset()

    def reset(self):
        self.values: List[float] = []

    def add(self, targets, predictions) -> float:
        score = native.edit_score_norm_native(predictions, targets, self.ignore_ids)
        if score is None:
            score = edit_score(
                recognized=predictions, ground_truth=targets, bg_class=self.ignore_ids,
            )
        self.values.append(score)
        return score

    def summary(self) -> float:
        return float(np.mean(self.values)) if self.values else 0.0


class F1Score(Metric):
    def __init__(
        self,
        overlaps: Sequence[float] = (0.1, 0.25, 0.5),
        ignore_ids: Iterable[int] = (),
    ):
        self.overlaps = list(overlaps)
        self.ignore_ids = ignore_ids
        self.reset()

    def reset(self):
        self.tp = [0.0] * len(self.overlaps)
        self.fp = [0.0] * len(self.overlaps)
        self.fn = [0.0] * len(self.overlaps)

    def add(self, targets, predictions) -> List[float]:
        counts = native.f_scores_multi_native(predictions, targets, self.overlaps,
                                              self.ignore_ids)
        if counts is None:
            counts = [
                f_score(predictions, targets, ov, self.ignore_ids) for ov in self.overlaps
            ]
        out = []
        for s, (tp1, fp1, fn1) in enumerate(counts):
            self.tp[s] += tp1
            self.fp[s] += fp1
            self.fn[s] += fn1
            out.append(self.get_f1_score(tp1, fp1, fn1))
        return out

    def summary(self) -> List[float]:
        return [
            self.get_f1_score(self.tp[s], self.fp[s], self.fn[s])
            for s in range(len(self.overlaps))
        ]

    @staticmethod
    def get_f1_score(tp: float, fp: float, fn: float) -> float:
        if tp + fp != 0.0:
            precision = tp / (tp + fp)
            recall = tp / (tp + fn)
        else:
            precision = recall = 0.0
        if precision + recall != 0.0:
            return 100.0 * 2.0 * precision * recall / (precision + recall)
        return 0.0
