"""Fused WaveNet eval stack (mucon_tpu/ops/wavenet_pallas_v2.py).

Everything after the in-projection: L dilated residual layers with 2x
pooling after `pooling_layers`, then nonlin -> out-projection -> mask.

* `wavenet_stack_plain` — plain PyTorch, the twin of the TPU kernel
  `_stack_kernel_v2` (wavenet_pallas_v2.py:67) on the same packed weights.
* `wavenet_stack` — dispatch by device: a CPU tensor takes the plain
  version, a CUDA tensor launches the hand-written kernel
  (`csrc/wavenet_stack.cu`, one launch per layer plus one for the
  out-projection, its products on the tensor cores in 3xTF32; the layer
  kernel, `csrc/wavenet_layer.cuh`, is the trainable forward's) or raises.

`mm_dtype=torch.bfloat16` is the JAX package's `mm_dtype=jnp.bfloat16`
(`tpu.kernel_mm_dtype=bfloat16`): every product on bf16-rounded operands
with f32 sums (`ops/bf16.py`), in the twin and in the kernels' bf16 mode.
"""

from __future__ import annotations

from typing import Sequence

import torch

from mucon_tpu_torch.models.layers import mask_time
from mucon_tpu_torch.models.temporal import nonlinearity, pool2_time, shift_time
from mucon_tpu_torch.ops.bf16 import matmul_bf16


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


def _mm(a, b):
    """Every product of the plain stack, in full f32.  (The CUDA kernels',
    eval and train, are error-compensated TF32, `ops/tf32.py`; the tests
    swap `matmul_3xtf32_plain`, or under autograd `Matmul3xTF32`, in here
    to hold the split to the f32 twin.)"""
    return a @ b


def _product(a, b, mm_dtype, round_grads: bool = True):
    """A product of the stack: `_mm` in f32 (mm_dtype None), or on
    bf16-rounded operands (mm_dtype torch.bfloat16; `round_grads` rounds
    the gradient products' operands too)."""
    if mm_dtype is None:
        return _mm(a, b)
    if mm_dtype != torch.bfloat16:
        raise ValueError(f"mm_dtype must be None or torch.bfloat16, got {mm_dtype}")
    return matmul_bf16(a, b, round_grads)


def wavenet_stack_plain(
    x,  # [B x T x C] f32, after the in-projection
    lengths,  # [B] int
    w3, b3, w1, b1, w_last, b_last,
    stages: Sequence[int],
    pooling_layers: Sequence[int],
    pooling_type: str = "max",
    leaky: bool = False,
    drop_masks=None,
    mm_dtype=None,
    round_proj_grads=None,
    pool_inputs=None,
):
    """Plain PyTorch stack. Returns (z [B x T/2^p x C], lengths >> p).
    `drop_masks` (train): one dropout mask [B x t_i x C] per layer,
    multiplied into the 1x1 conv's output before the residual.  With
    `mm_dtype=torch.bfloat16` every product rounds its operands to bf16; the
    out-projection's gradient does not when the last layer pools (the JAX
    package's v3 takes it in f32 outside its kernel then) unless
    `round_proj_grads` is True (its v2, which takes it in the kernel).
    `pool_inputs` (a check's): {pooled layer: the pre-pool values} that
    the max pool compares in place of the twin's own (the gradient still
    flows through the twin's), so that a pair within rounding of a tie
    routes its gradient as the kernel that produced them routes it."""
    x = mask_time(x, lengths)
    ln = lengths
    for i, d in enumerate(stages):
        z = (
            _product(shift_time(x, -d), w3[i, 0], mm_dtype)
            + _product(x, w3[i, 1], mm_dtype)
            + _product(shift_time(x, d), w3[i, 2], mm_dtype)
            + b3[i]
        )
        y = _product(nonlinearity(z, leaky), w1[i], mm_dtype) + b1[i]
        if drop_masks is not None:
            y = y * drop_masks[i]
        x = mask_time(y + x, ln)
        if i in pooling_layers:
            if pool_inputs is not None:
                x = pool_inputs[i] + (x - x.detach())
            x = pool2_time(x, pooling_type)
            ln = ln // 2
            x = mask_time(x, ln)
    if round_proj_grads is None:
        round_proj_grads = len(stages) - 1 not in pooling_layers
    x = _product(nonlinearity(x, leaky), w_last, mm_dtype, round_proj_grads) + b_last
    return mask_time(x, ln), ln


def wavenet_stack(
    x, lengths, w3, b3, w1, b1, w_last, b_last,
    stages: Sequence[int],
    pooling_layers: Sequence[int],
    pooling_type: str = "max",
    leaky: bool = False,
    mm_dtype=None,
):
    """`wavenet_stack_plain` on a CPU tensor; the CUDA kernel on a CUDA
    tensor (raises on what the kernel does not take)."""
    args = (x, lengths, w3, b3, w1, b1, w_last, b_last)
    if x.device.type == "cpu":
        return wavenet_stack_plain(
            *args, stages=stages, pooling_layers=pooling_layers,
            pooling_type=pooling_type, leaky=leaky, mm_dtype=mm_dtype,
        )
    from mucon_tpu_torch import cuda

    return cuda.wavenet_stack(
        *args, stages=tuple(stages),
        pooling_layers=tuple(int(p) for p in pooling_layers),
        pooling_type=pooling_type, leaky=leaky, mm_dtype=mm_dtype,
    )
