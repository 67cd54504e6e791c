"""Fused WaveNet eval stack (mucon_tpu/ops/wavenet_pallas_v2.py).

Everything after the in-projection: L dilated residual layers with 2x
pooling after `pooling_layers`, then nonlin -> out-projection -> mask.

* `wavenet_stack_plain` — plain PyTorch, the twin of the TPU kernel
  `_stack_kernel_v2` (wavenet_pallas_v2.py:67) on the same packed weights.
* `wavenet_stack` — dispatch by device: a CPU tensor takes the plain
  version, a CUDA tensor launches the hand-written kernel
  (`csrc/wavenet_stack.cu`, one launch per layer plus one for the
  out-projection) or raises.
"""

from __future__ import annotations

from typing import Sequence

import torch

from mucon_tpu_torch.models.layers import mask_time
from mucon_tpu_torch.models.temporal import nonlinearity, pool2_time, shift_time


def pack_wavenet_params(block) -> tuple:
    """Stack a `WaveNetBlock`'s per-layer weights into the kernel's packed
    arrays (wavenet_pallas_v2.py:219): w3 [L, 3, C, C], b3 [L, C],
    w1 [L, C, C], b1 [L, C], w_last [C, C], b_last [C].  The in-projection
    `Conv1x1_0` is not packed (it runs as a plain matmul before the stack)."""
    layers = [getattr(block, f"WaveNetLayer_{i}") for i in range(len(block.stages))]
    w3 = torch.stack([l.DilatedConv3_0.kernel for l in layers])
    b3 = torch.stack([l.DilatedConv3_0.bias for l in layers])
    w1 = torch.stack([l.Conv1x1_0.kernel for l in layers])
    b1 = torch.stack([l.Conv1x1_0.bias for l in layers])
    return w3, b3, w1, b1, block.Conv1x1_1.kernel, block.Conv1x1_1.bias


def wavenet_stack_plain(
    x,  # [B x T x C] f32, after the in-projection
    lengths,  # [B] int
    w3, b3, w1, b1, w_last, b_last,
    stages: Sequence[int],
    pooling_layers: Sequence[int],
    pooling_type: str = "max",
    leaky: bool = False,
    drop_masks=None,
):
    """Plain PyTorch stack. Returns (z [B x T/2^p x C], lengths >> p).
    `drop_masks` (train): one dropout mask [B x t_i x C] per layer,
    multiplied into the 1x1 conv's output before the residual."""
    x = mask_time(x, lengths)
    ln = lengths
    for i, d in enumerate(stages):
        z = (
            shift_time(x, -d) @ w3[i, 0]
            + x @ w3[i, 1]
            + shift_time(x, d) @ w3[i, 2]
            + b3[i]
        )
        y = nonlinearity(z, leaky) @ w1[i] + b1[i]
        if drop_masks is not None:
            y = y * drop_masks[i]
        x = mask_time(y + x, ln)
        if i in pooling_layers:
            x = pool2_time(x, pooling_type)
            ln = ln // 2
            x = mask_time(x, ln)
    x = nonlinearity(x, leaky) @ w_last + b_last
    return mask_time(x, ln), ln


def wavenet_stack(
    x, lengths, w3, b3, w1, b1, w_last, b_last,
    stages: Sequence[int],
    pooling_layers: Sequence[int],
    pooling_type: str = "max",
    leaky: bool = False,
):
    """`wavenet_stack_plain` on a CPU tensor; the CUDA kernel on a CUDA
    tensor (raises on what the kernel does not take)."""
    args = (x, lengths, w3, b3, w1, b1, w_last, b_last)
    if x.device.type == "cpu":
        return wavenet_stack_plain(
            *args, stages=stages, pooling_layers=pooling_layers,
            pooling_type=pooling_type, leaky=leaky,
        )
    from mucon_tpu_torch import cuda

    return cuda.wavenet_stack(
        *args, stages=tuple(stages),
        pooling_layers=tuple(int(p) for p in pooling_layers),
        pooling_type=pooling_type, leaky=leaky,
    )
