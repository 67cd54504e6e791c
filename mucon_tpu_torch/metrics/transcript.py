"""Transcript-quality metrics: matching score and length difference
(mucon_tpu/metrics/transcript.py; the native kernel where it loads,
`mucon_tpu_torch/native`, else the numpy path below).

The reference scores predicted transcripts with
`edit_distance.SequenceMatcher.ratio()` (src/core/metrics/transcript.py):
ratio = 2 * matches / (len(a) + len(b)), where `matches` counts aligned
equal pairs along a minimum-edit-distance (unit-cost Levenshtein) alignment.
The same quantity comes from a DP that minimizes distance
and, among minimal-distance alignments, maximizes matches (the package
breaks cost ties in favor of matches too).
"""

from typing import List, Sequence, Tuple

import numpy as np

from mucon_tpu_torch import native
from mucon_tpu_torch.metrics.base import Metric


def levenshtein_matches(a: Sequence, b: Sequence) -> Tuple[int, int]:
    """(edit_distance, matches) for a max-match minimal alignment; the
    native kernel computes them when it is loaded."""
    found = native.levenshtein_matches_native(a, b)
    if found is not None:
        return found
    la, lb = len(a), len(b)
    # dp over (cost, -matches) lexicographic minimum
    INF = la + lb + 1
    cost = np.zeros((la + 1, lb + 1), np.int64)
    match = np.zeros((la + 1, lb + 1), np.int64)
    cost[0, :] = np.arange(lb + 1)
    cost[:, 0] = np.arange(la + 1)
    for i in range(1, la + 1):
        for j in range(1, lb + 1):
            eq = a[i - 1] == b[j - 1]
            cands = (
                (cost[i - 1, j - 1] + (0 if eq else 1), match[i - 1, j - 1] + (1 if eq else 0)),
                (cost[i - 1, j] + 1, match[i - 1, j]),
                (cost[i, j - 1] + 1, match[i, j - 1]),
            )
            best = min(cands, key=lambda cm: (cm[0], -cm[1]))
            cost[i, j], match[i, j] = best
    return int(cost[la, lb]), int(match[la, lb])


def calculate_matching_score(
    gt_transcript: List[int], predicted_transcript: List[int]
) -> float:
    total = len(gt_transcript) + len(predicted_transcript)
    if total == 0:
        return 1.0
    _, matches = levenshtein_matches(gt_transcript, predicted_transcript)
    return 2.0 * matches / total


def calculate_abs_len_diff(
    gt_transcript: List[int], predicted_transcript: List[int]
) -> int:
    return abs(len(predicted_transcript) - len(gt_transcript))


class MatchingScoreMetric(Metric):
    def __init__(self):
        self.reset()

    def reset(self):
        self.values: List[float] = []

    def add(self, target_transcript, predicted_transcript) -> float:
        score = calculate_matching_score(
            list(target_transcript), list(predicted_transcript)
        )
        self.values.append(score)
        return score

    def summary(self) -> float:
        return float(np.mean(self.values)) if self.values else 0.0


class AbsLenDiffMetric(MatchingScoreMetric):
    def add(self, target_transcript, predicted_transcript) -> float:
        score = calculate_abs_len_diff(
            list(target_transcript), list(predicted_transcript)
        )
        self.values.append(score)
        return score
