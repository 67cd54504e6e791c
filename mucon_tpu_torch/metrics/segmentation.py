"""Framewise segmentation metrics: MoF, IoD, IoU (mucon_tpu/metrics/segmentation.py).
The overlap scores run in the native kernel where it loads
(`mucon_tpu_torch/native`), else in the numpy path below.

Semantics pinned to the reference (src/core/metrics/segmentation.py and the
ISBA-derived overlap scores in isba_code.py, un-scaled — no x100):

* MoF: running correct/total with `ignore_ids` masked out of the TARGETS.
* IoD/IoU: per video, for every ground-truth segment take the best
  intersection-over-(detection|union) against same-label predicted
  segments; average over GT segments; the metric averages over videos.
"""

from typing import Iterable, List, Tuple

import numpy as np

from mucon_tpu_torch import native
from mucon_tpu_torch.metrics.base import Metric


def careful_divide(correct, total, zero_value: float = 0.0) -> float:
    return zero_value if total == 0 else correct / total


def segment_intervals_and_labels(
    y: np.ndarray,
) -> Tuple[List[Tuple[int, int]], List[int]]:
    """RLE a framewise label sequence into ([start, end) intervals, labels)."""
    y = np.asarray(y)
    boundaries = [0] + (np.nonzero(np.diff(y))[0] + 1).tolist() + [len(y)]
    intervals = [(boundaries[i], boundaries[i + 1]) for i in range(len(boundaries) - 1)]
    labels = [int(y[b]) for b in boundaries[:-1]]
    return intervals, labels


def _overlap_score(
    prediction: np.ndarray,
    target: np.ndarray,
    ignore_ids: Iterable[int],
    union_denominator: bool,
) -> float:
    """Best per-GT-segment overlap, averaged. union_denominator selects IoU
    vs IoD (denominator = union vs predicted-segment length); the native
    kernel computes it when it is loaded."""
    score = native.overlap_score_native(prediction, target, list(ignore_ids),
                                        union_denominator)
    if score is not None:
        return float(score)
    ignore = set(int(i) for i in ignore_ids)
    t_iv, t_lb = segment_intervals_and_labels(target)
    p_iv, p_lb = segment_intervals_and_labels(prediction)
    if ignore:
        t_iv = [iv for iv, l in zip(t_iv, t_lb) if l not in ignore]
        t_lb = [l for l in t_lb if l not in ignore]
        p_iv = [iv for iv, l in zip(p_iv, p_lb) if l not in ignore]
        p_lb = [l for l in p_lb if l not in ignore]

    scores = np.zeros(len(t_lb))
    for i, ((ts, te), tl) in enumerate(zip(t_iv, t_lb)):
        for (ps, pe), plb in zip(p_iv, p_lb):
            if tl != plb:
                continue
            inter = min(pe, te) - max(ps, ts)
            denom = (max(pe, te) - min(ps, ts)) if union_denominator else (pe - ps)
            scores[i] = max(scores[i], inter / denom)
    with np.errstate(invalid="ignore"):
        return float(scores.mean())  # nan for videos with no GT segments,
        # matching the reference's np.zeros(0).mean() behavior


def iod(prediction, target, ignore_ids: Iterable[int] = ()) -> float:
    return _overlap_score(prediction, target, ignore_ids, union_denominator=False)


def iou(prediction, target, ignore_ids: Iterable[int] = ()) -> float:
    return _overlap_score(prediction, target, ignore_ids, union_denominator=True)


class MoFAccuracyMetric(Metric):
    def __init__(self, ignore_ids: Iterable[int] = ()):
        self.ignore_ids = ignore_ids
        self.reset()

    def reset(self):
        self.total = 0
        self.correct = 0

    def add(self, targets, predictions) -> float:
        assert len(targets) == len(predictions)
        targets = np.asarray(targets)
        predictions = np.asarray(predictions)
        mask = np.logical_not(np.isin(targets, list(self.ignore_ids)))
        targets, predictions = targets[mask], predictions[mask]
        current_correct = int((targets == predictions).sum())
        current_total = len(targets)
        self.correct += current_correct
        self.total += current_total
        return careful_divide(current_correct, current_total)

    def summary(self) -> float:
        return careful_divide(self.correct, self.total)


def _host(a) -> np.ndarray:
    """numpy of an array, or of a torch tensor on any device (in float32
    when it is a float of another width)."""
    if hasattr(a, "detach"):  # a torch tensor: to the host, without importing torch
        a = a.detach()
        if a.is_floating_point():
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


class MoFAccuracyFromLogitsMetric(MoFAccuracyMetric):
    """MoF of the argmax of framewise logits [T x M] (segmentation.py:105):
    ties go to the first index.  Targets and logits may be numpy arrays or
    torch tensors on any device."""

    def add(self, targets, logits) -> float:
        return super().add(_host(targets), _host(logits).argmax(-1))


class IoDMetric(Metric):
    _fn = staticmethod(iod)

    def __init__(self, ignore_ids: Iterable[int] = ()):
        self.ignore_ids = ignore_ids
        self.reset()

    def reset(self):
        self.values: List[float] = []

    def add(self, targets, predictions) -> float:
        assert len(targets) == len(predictions)
        result = self._fn(np.asarray(predictions), np.asarray(targets), self.ignore_ids)
        self.values.append(result)
        return result

    def summary(self) -> float:
        if len(self.values) > 0:
            return sum(self.values) / len(self.values)
        return 0.0


class IoUMetric(IoDMetric):
    _fn = staticmethod(iou)
