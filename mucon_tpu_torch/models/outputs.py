"""Forward, loss and prediction containers (mucon_tpu/models/outputs.py),
field for field."""

from dataclasses import dataclass
from typing import List

import numpy as np
import torch


@dataclass
class MuConForwardOut:
    transcript: torch.Tensor  # [B x S x (M+1)] per-step log-softmax logits
    lengths: torch.Tensor  # [B x S] raw (un-normalized) length scalars
    segmentation: torch.Tensor  # [B x T x M] framewise logits (y head)
    tokens: torch.Tensor  # [B x S] per-step argmax token ids
    n_steps: torch.Tensor  # [B] decode steps used (first EOS + 1, or S)
    tz_lengths: torch.Tensor  # [B] encoder output lengths (T_i >> pools)
    segmentation_z: torch.Tensor = None  # [B x Tz x M] pre-upsample logits:
    # segmentation == nearest-upsample(segmentation_z) row for row
    teacher_forced: bool = False  # decoded the ground truth (train, alignment)


@dataclass
class MuConLoss:
    main: torch.Tensor  # the weighted sum that is differentiated
    transcript_loss: torch.Tensor
    mucon_loss: torch.Tensor
    length_loss: torch.Tensor
    smoothing_loss: torch.Tensor


@dataclass
class MuConFullySupervisedLoss(MuConLoss):
    classification_loss: torch.Tensor
    supervised_length_loss: torch.Tensor


class MuConPredictOut:
    """Host-side per-video predictions (the reference's models.py:112-131)."""

    def __init__(self, transcript: List[int], lengths: np.ndarray,
                 segmentation_logits: np.ndarray):
        self.transcript = transcript  # includes EOS, length N + 1
        self.lengths = lengths  # [N] softmaxed, sums to 1
        self.segmentation_logits = segmentation_logits  # [T x M] log-softmax
