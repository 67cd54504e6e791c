"""Temporal encoders (mucon_tpu/models/temporal.py): the WaveNet block
(:32-163), the MS-TCN++ first stage (:166) and the one-conv `NoFt` (:200).

Channel-last [B x T x C]; 1x1 convs are matmuls over channels, the k=3
dilated conv is three shifted matmuls, and lengths are re-masked after
every time-mixing op.  Parameters carry the flax names and layouts
(`Conv1x1_0.kernel` [in, out], `DilatedConv3_0.kernel` [3, in, out]) so
the weight bridge is a renaming of keys.

This module path is the plain reference of the whole block; the fused
residual stack (everything after the in-projection) is
`mucon_tpu_torch.ops.wavenet_stack` (eval) and
`mucon_tpu_torch.ops.wavenet_stack_train` (train), whose CUDA kernels it
checks; the MS-TCN++ stage's eval kernel is `ops/mstcnpp_stack.py` (it
trains as plain PyTorch, as the JAX package trains it on XLA).  Dropout is a per-layer mask tensor ([B x t x C], from
`layers.dropout_mask`) multiplied into the 1x1 conv's output before the
residual; without masks the block is the eval forward.

`dtype` is the compute dtype (the JAX package's `tpu.compute_dtype`,
temporal.py:53-90): a conv casts its input, kernel and bias to it, so under
bfloat16 every product and sum of the block rounds to bf16 where the flax
modules round; the parameters stay f32.
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
    """ReLU or leaky ReLU; at exactly 0 the gradient is 0 (0.01 leaky), as
    in the JAX package's train kernel (`_nonlin_grad_from_h`) and flax's
    relu.  Exact zeros are common: dropped entries of a ReLU'd input."""
    return torch.where(x > 0, x, 0.01 * x) if leaky else torch.relu(x)


def dropped(y: torch.Tensor, mask) -> torch.Tensor:
    """y times its dropout mask (f32: 0 or 1 / (1 - rate)) in y's dtype, as
    flax's Dropout keeps it."""
    return y if mask is None else (y * mask).to(y.dtype)


class Conv1x1(nn.Module):
    """Pointwise conv == dense over channels; kernel [in, out]; input,
    kernel and bias cast to `dtype` (temporal.py:52-61)."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, generator: torch.Generator):
        for p in (self.kernel, self.bias):
            torch_linear_init_(p, self.kernel.shape[0], generator)

    def forward(self, x):
        dt = self.dtype
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


class DilatedConv3(nn.Module):
    """Kernel-3 dilated conv with SAME zero padding; kernel [3, in, out];
    input, kernel and bias cast to `dtype` (temporal.py:64-90)."""

    def __init__(self, channels_in: int, channels_out: int, dilation: int,
                 dtype=torch.float32):
        super().__init__()
        self.dilation = dilation
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(3, channels_in, channels_out))
        self.bias = nn.Parameter(torch.empty(channels_out))

    def reset_parameters(self, generator: torch.Generator):
        for p in (self.kernel, self.bias):
            torch_linear_init_(p, 3 * self.kernel.shape[1], generator)

    def forward(self, x):
        d, dt = self.dilation, self.dtype
        w, x = self.kernel.to(dt), x.to(dt)
        y = shift_time(x, -d) @ w[0] + x @ w[1] + shift_time(x, d) @ w[2]
        return y + self.bias.to(dt)


class WaveNetLayer(nn.Module):
    """Dilated conv3 -> nonlin -> 1x1 -> residual -> mask."""

    def __init__(self, channels: int, dilation: int, leaky: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.leaky = leaky
        self.DilatedConv3_0 = DilatedConv3(channels, channels, dilation, dtype)
        self.Conv1x1_0 = Conv1x1(channels, channels, dtype)

    def forward(self, x, lengths, drop_mask=None):
        y = self.Conv1x1_0(nonlinearity(self.DilatedConv3_0(x), self.leaky))
        return mask_time(dropped(y, drop_mask) + x, lengths)


def pool2_time(x: torch.Tensor, pooling_type: str) -> torch.Tensor:
    """Downsample time by 2: max, or mean * 2 for "sum" (floor(T/2) rows).
    The max routes its gradient to the FIRST element of a tied pair (torch
    max_pool1d, as the JAX train kernel's `_pool2_bwd_xla`); `amax` would
    split it."""
    B, T, C = x.shape
    pairs = x[:, : (T // 2) * 2].reshape(B, T // 2, 2, C)
    a, b = pairs[:, :, 0], pairs[:, :, 1]
    if pooling_type == "max":
        return torch.where(b > a, b, a)
    return (a + b) * 0.5 * 2.0


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
        dtype=torch.float32,
    ):
        super().__init__()
        self.stages = tuple(stages)
        self.pooling_layers = tuple(int(p) for p in pooling_layers)
        self.pooling_type = pooling_type
        self.leaky = leaky
        self.Conv1x1_0 = Conv1x1(in_channels, out_dims, dtype)
        for i, d in enumerate(self.stages):
            self.add_module(f"WaveNetLayer_{i}", WaveNetLayer(out_dims, d, leaky, dtype))
        self.Conv1x1_1 = Conv1x1(out_dims, out_dims, dtype)

    def in_projection(self, x, lengths):
        """nonlin(x @ W_in + b_in), masked — the D -> C projection."""
        return mask_time(nonlinearity(self.Conv1x1_0(x), self.leaky), lengths)

    def forward(self, x, lengths, drop_masks=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """`drop_masks`: one [B x t_i x C] dropout mask per layer (train), or
        None (eval)."""
        x = self.in_projection(x, lengths)
        for i in range(len(self.stages)):
            m = None if drop_masks is None else drop_masks[i]
            x = getattr(self, f"WaveNetLayer_{i}")(x, lengths, m)
            if i in self.pooling_layers:
                x = pool2_time(x, self.pooling_type)
                lengths = lengths // 2
                x = mask_time(x, lengths)
        x = self.Conv1x1_1(nonlinearity(x, self.leaky))
        return mask_time(x, lengths), lengths


class MSTCNPPFirstStage(nn.Module):
    """Dual-dilation MS-TCN++ first stage (mucon_tpu/models/temporal.py:166).

    Flax names: `Conv1x1_0` the D -> C in-projection; per layer i
    `DilatedConv3_{2i}` (d1 = 2^(L-1-i), falling) and `DilatedConv3_{2i+1}`
    (d2 = 2^i, rising), `Conv1x1_{i+1}` (2C -> C over their concat);
    `Conv1x1_{L+1}` the out-projection.  Reference quirks kept: no ReLU
    after the in-projection, none before the out-projection, dropout at
    the module default 0.5, max pooling at `pooling_layers` always."""

    dropout_rate = 0.5  # mucon.py never passes ft.dropout_rate to the stage

    def __init__(self, input_dim: int, num_layers: int, num_f_maps: int, output_dim: int,
                 pooling_layers: Sequence[int] = (1, 2, 4, 8), dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.pooling_layers = tuple(int(p) for p in pooling_layers)
        C = num_f_maps
        self.Conv1x1_0 = Conv1x1(input_dim, C, dtype)
        for i in range(num_layers):
            self.add_module(f"DilatedConv3_{2 * i}",
                            DilatedConv3(C, C, 2 ** (num_layers - 1 - i), dtype))
            self.add_module(f"DilatedConv3_{2 * i + 1}", DilatedConv3(C, C, 2 ** i, dtype))
            self.add_module(f"Conv1x1_{i + 1}", Conv1x1(2 * C, C, dtype))
        self.add_module(f"Conv1x1_{num_layers + 1}", Conv1x1(C, output_dim, dtype))

    def in_projection(self, x, lengths):
        """x @ W_in + b_in, masked — no nonlinearity."""
        return mask_time(self.Conv1x1_0(x), lengths)

    def forward(self, x, lengths, drop_masks=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """`drop_masks`: one [B x t_i x C] dropout mask per layer (train), or
        None (eval)."""
        f = self.in_projection(x, lengths)
        for i in range(self.num_layers):
            y1 = getattr(self, f"DilatedConv3_{2 * i}")(f)
            y2 = getattr(self, f"DilatedConv3_{2 * i + 1}")(f)
            y = torch.relu(getattr(self, f"Conv1x1_{i + 1}")(torch.cat([y1, y2], dim=-1)))
            y = dropped(y, None if drop_masks is None else drop_masks[i])
            f = mask_time(y + f, lengths)
            if i in self.pooling_layers:
                f = pool2_time(f, "max")
                lengths = lengths // 2
                f = mask_time(f, lengths)
        out = getattr(self, f"Conv1x1_{self.num_layers + 1}")(f)
        return mask_time(out, lengths), lengths


class NoFt(nn.Module):
    """One masked 1x1 conv, no pooling (mucon_tpu/models/temporal.py:200)."""

    def __init__(self, in_channels: int, out_dims: int, dtype=torch.float32):
        super().__init__()
        self.Conv1x1_0 = Conv1x1(in_channels, out_dims, dtype)

    in_projection = MSTCNPPFirstStage.in_projection

    def forward(self, x, lengths, drop_masks=None) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.in_projection(x, lengths), lengths
