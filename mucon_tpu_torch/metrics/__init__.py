"""Metrics of the port (mucon_tpu/metrics): numpy, no jax."""

from mucon_tpu_torch.metrics.base import Metric
from mucon_tpu_torch.metrics.fully_supervised import Edit, F1Score, edit_score, f_score
from mucon_tpu_torch.metrics.segmentation import (
    IoDMetric,
    IoUMetric,
    MoFAccuracyFromLogitsMetric,
    MoFAccuracyMetric,
    careful_divide,
    iod,
    iou,
)
from mucon_tpu_torch.metrics.transcript import (
    AbsLenDiffMetric,
    MatchingScoreMetric,
    calculate_abs_len_diff,
    calculate_matching_score,
)

__all__ = [
    "Metric",
    "MoFAccuracyMetric",
    "MoFAccuracyFromLogitsMetric",
    "IoDMetric",
    "IoUMetric",
    "Edit",
    "F1Score",
    "MatchingScoreMetric",
    "AbsLenDiffMetric",
    "careful_divide",
    "iod",
    "iou",
    "edit_score",
    "f_score",
    "calculate_matching_score",
    "calculate_abs_len_diff",
]
