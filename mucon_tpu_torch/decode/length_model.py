"""Segment-length models for Viterbi decoding (mucon_tpu/decode/length_model.py),
host code in numpy.

Semantics are the reference's (its src/core/viterbi/length_model.py),
including the renormalized-Poisson quirks that the vit_* metrics depend on:

* the normalizer uses round(mean) for the first two terms but the log
  factorial runs to int(mean) (truncation);
* length 0 is impossible (-inf);
* lengths >= max_length score -inf.
"""

from __future__ import annotations

from typing import List

import numpy as np
from scipy.special import gammaln


class LengthModel:
    def n_classes(self) -> int:
        return 0

    def score(self, length: int, label: int) -> float:
        return 0.0

    def max_length(self):
        return np.inf


class MeanLengthModel(LengthModel):
    """Exponential penalty beyond a threshold."""

    def __init__(self, num_classes, max_length=2000, threshold=200.0, alpha=0.9):
        self.num_classes = num_classes
        self.max_len = max_length
        self.threshold = threshold
        self.alpha = alpha

    def n_classes(self):
        return self.num_classes

    def score(self, length, label):
        if length <= self.threshold:
            return 0.0
        if length > self.max_len:
            return -np.inf
        return (length - self.threshold) * np.log(self.alpha)

    def max_length(self):
        return self.max_len


def poisson_log_table(mean_lengths: np.ndarray, max_length: int = 2000,
                      renormalize: bool = True) -> np.ndarray:
    """Log Poisson scores [max_length x C]:
    table[l, c] = l*log(lam_c) - lam_c - log(l!) - norm_c, table[0, :] = -inf,
    norm_c = round(lam)*log(round(lam)) - round(lam) - log(int(lam)!)."""
    lam = np.asarray(mean_lengths, dtype=np.float64)
    C = lam.shape[0]
    with np.errstate(divide="ignore", invalid="ignore"):
        norms = np.zeros(C)
        if renormalize:
            r = np.round(lam)
            norms = r * np.log(r) - r - gammaln(lam.astype(np.int64) + 1)
        lengths = np.arange(max_length, dtype=np.float64)
        log_fak = gammaln(lengths + 1)  # log(l!)
        table = (lengths[:, None] * np.log(lam)[None, :] - lam[None, :]
                 - log_fak[:, None] - norms[None, :])
    table[0, :] = -np.inf
    return table


class PoissonModel(LengthModel):
    """Per-class Poisson with the renormalization above."""

    def __init__(self, model, max_length: int = 2000, renormalize: bool = True):
        if isinstance(model, str):
            self.mean_lengths = np.loadtxt(model)
        else:
            self.mean_lengths = np.asarray(model, dtype=np.float64)
        self.num_classes = self.mean_lengths.shape[0]
        self.max_len = max_length
        self.poisson = poisson_log_table(self.mean_lengths, max_length, renormalize)

    def n_classes(self):
        return self.num_classes

    def score(self, length, label):
        if length >= self.max_len:
            return -np.inf
        return self.poisson[length, label]

    def max_length(self):
        return self.max_len


class MultiPoissonModel(LengthModel):
    """Per-segment Poisson models.  A dead path in the reference too: no
    config enables it and `score` is unsupported."""

    def __init__(self, list_of_lengths: List[float], num_classes: int):
        self.num_classes = num_classes
        self.poisson_models = [PoissonModel(np.full(num_classes, n, dtype=np.float32))
                               for n in list_of_lengths]

    def n_classes(self):
        return self.num_classes

    def max_length(self):
        return self.poisson_models[0].max_len

    def score(self, length, label):
        raise NotImplementedError

    def score_multi(self, index, length, label):
        return self.poisson_models[index].score(length, label)
