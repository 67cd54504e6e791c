"""WaveNet temporal encoder, eval path (mucon_tpu/models/temporal.py:32-163).

Channel-last [B x T x C]; 1x1 convs are matmuls over channels, the k=3
dilated conv is three shifted matmuls, and lengths are re-masked after
every time-mixing op.  Parameters carry the flax names and layouts
(`Conv1x1_0.kernel` [in, out], `DilatedConv3_0.kernel` [3, in, out]) so
the weight bridge is a renaming of keys.

This module path is the plain reference of the whole block; the fused
residual stack (everything after the in-projection) is
`mucon_tpu_torch.ops.wavenet_stack`, whose CUDA kernel it checks.
Dropout is absent: the port is inference only.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from mucon_tpu_torch.models.layers import mask_time, torch_linear_init_


def shift_time(x: torch.Tensor, offset: int) -> torch.Tensor:
    """x[:, t + offset, :] with zero fill; all zeros when |offset| >= T
    (the 512/1024 dilations on pooled short sequences)."""
    if offset == 0:
        return x
    T = x.shape[1]
    out = torch.zeros_like(x)
    if abs(offset) >= T:
        return out
    if offset > 0:
        out[:, : T - offset] = x[:, offset:]
    else:
        out[:, -offset:] = x[:, : T + offset]
    return out


def nonlinearity(x: torch.Tensor, leaky: bool) -> torch.Tensor:
    return torch.where(x > 0, x, 0.01 * x) if leaky else torch.clamp(x, min=0.0)


class Conv1x1(nn.Module):
    """Pointwise conv == dense over channels; kernel [in, out]."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, generator: torch.Generator):
        for p in (self.kernel, self.bias):
            torch_linear_init_(p, self.kernel.shape[0], generator)

    def forward(self, x):
        return x @ self.kernel + self.bias


class DilatedConv3(nn.Module):
    """Kernel-3 dilated conv with SAME zero padding; kernel [3, in, out]."""

    def __init__(self, channels_in: int, channels_out: int, dilation: int):
        super().__init__()
        self.dilation = dilation
        self.kernel = nn.Parameter(torch.empty(3, channels_in, channels_out))
        self.bias = nn.Parameter(torch.empty(channels_out))

    def reset_parameters(self, generator: torch.Generator):
        for p in (self.kernel, self.bias):
            torch_linear_init_(p, 3 * self.kernel.shape[1], generator)

    def forward(self, x):
        d, w = self.dilation, self.kernel
        y = shift_time(x, -d) @ w[0] + x @ w[1] + shift_time(x, d) @ w[2]
        return y + self.bias


class WaveNetLayer(nn.Module):
    """Dilated conv3 -> nonlin -> 1x1 -> residual -> mask."""

    def __init__(self, channels: int, dilation: int, leaky: bool = False):
        super().__init__()
        self.leaky = leaky
        self.DilatedConv3_0 = DilatedConv3(channels, channels, dilation)
        self.Conv1x1_0 = Conv1x1(channels, channels)

    def forward(self, x, lengths):
        y = nonlinearity(self.DilatedConv3_0(x), self.leaky)
        return mask_time(self.Conv1x1_0(y) + x, lengths)


def pool2_time(x: torch.Tensor, pooling_type: str) -> torch.Tensor:
    """Downsample time by 2: max, or mean * 2 for "sum" (floor(T/2) rows)."""
    B, T, C = x.shape
    pairs = x[:, : (T // 2) * 2].reshape(B, T // 2, 2, C)
    if pooling_type == "max":
        return pairs.amax(dim=2)
    return pairs.mean(dim=2) * 2.0


class WaveNetBlock(nn.Module):
    """In-projection, dilated residual layers with pooling, out-projection.
    Returns (features [B x T' x C], lengths')."""

    def __init__(
        self,
        in_channels: int,
        stages: Sequence[int],
        out_dims: int,
        pooling_layers: Sequence[int],
        pooling_type: str = "max",
        leaky: bool = False,
    ):
        super().__init__()
        self.stages = tuple(stages)
        self.pooling_layers = tuple(int(p) for p in pooling_layers)
        self.pooling_type = pooling_type
        self.leaky = leaky
        self.Conv1x1_0 = Conv1x1(in_channels, out_dims)
        for i, d in enumerate(self.stages):
            self.add_module(f"WaveNetLayer_{i}", WaveNetLayer(out_dims, d, leaky))
        self.Conv1x1_1 = Conv1x1(out_dims, out_dims)

    def in_projection(self, x, lengths):
        """nonlin(x @ W_in + b_in), masked — the D -> C projection."""
        return mask_time(nonlinearity(self.Conv1x1_0(x), self.leaky), lengths)

    def forward(self, x, lengths) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.in_projection(x, lengths)
        for i in range(len(self.stages)):
            x = getattr(self, f"WaveNetLayer_{i}")(x, lengths)
            if i in self.pooling_layers:
                x = pool2_time(x, self.pooling_type)
                lengths = lengths // 2
                x = mask_time(x, lengths)
        x = self.Conv1x1_1(nonlinearity(x, self.leaky))
        return mask_time(x, lengths), lengths
