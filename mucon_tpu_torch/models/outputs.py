"""Forward output container (mucon_tpu/models/outputs.py:19), field for field."""

from dataclasses import dataclass

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
