"""Trainable fused WaveNet stack (mucon_tpu/ops/wavenet_train_pallas_v3.py).

Everything after the in-projection, differentiable: L dilated residual
layers, each with its dropout mask multiplied into the 1x1 conv's output
before the residual, 2x pooling after `pooling_layers` (max routes the
gradient to the first element of a tied pair), then nonlin ->
out-projection -> mask.

* `wavenet_stack_train_plain` — plain PyTorch under autograd on the packed
  weights of `pack_wavenet_params`: `wavenet_stack_plain` with the masks.
* `WaveNetStackTrain` — a `torch.autograd.Function` whose forward and
  backward are the hand-written kernels of `csrc/wavenet_train.cu` (the
  forward stashes each layer's nonlin(z) and pooled layers' pre-pool
  output; the backward sweeps the layers last first).
* `wavenet_stack_train` — dispatch by device: a CPU tensor takes the plain
  twin, a CUDA tensor the Function (which raises on what the kernels do
  not take).

The dropout masks are inputs (one [B x t_i x C] tensor per layer, from
`layers.dropout_mask`, or None for no dropout); nothing random happens in
the kernels.  The TPU version's batch slicing and VMEM layer groups exist
for the TPU's memory and compiler only and are not ported.

`mm_dtype=torch.bfloat16` is the bf16-operand mode (`ops/bf16.py`): the twin
rounds every product's operands, its gradient products' too, and the
Function launches the kernels' bf16 mode.
"""

from __future__ import annotations

from typing import Sequence

import torch

from mucon_tpu_torch.models.layers import mask_time
from mucon_tpu_torch.ops.wavenet_stack import wavenet_stack_plain

wavenet_stack_train_plain = wavenet_stack_plain


def stack_plan(stages: Sequence[int], pooling_layers: Sequence[int], t_in: int):
    """Per-layer input lengths, pooled flags and pools-before counts, and
    the output length (wavenet_train_pallas_v2.py:52 `_plan`)."""
    t, shift = t_in, 0
    t_ins, pooled, shifts = [], [], []
    for i in range(len(stages)):
        t_ins.append(t)
        shifts.append(shift)
        pooled.append(i in pooling_layers)
        if pooled[-1]:
            t, shift = t // 2, shift + 1
    return t_ins, pooled, shifts, t


class WaveNetStackTrain(torch.autograd.Function):
    """The stack on the card: forward and backward are CUDA kernels."""

    @staticmethod
    def forward(ctx, x, lengths, w3, b3, w1, b1, w_last, b_last, drop_masks, statics):
        """`statics`: stages, pooling_layers, pooling_type, leaky and mm_dtype."""
        from mucon_tpu_torch import cuda

        x = mask_time(x, lengths).contiguous()
        z, stash = cuda.wavenet_train_forward(
            x, lengths, w3, b3, w1, b1, w_last, b_last, drop_masks, **statics
        )
        ctx.save_for_backward(lengths, w3, w1, w_last)
        ctx.stash, ctx.drop_masks, ctx.statics = stash, drop_masks, statics
        return z

    @staticmethod
    def backward(ctx, gz):
        from mucon_tpu_torch import cuda

        lengths, w3, w1, w_last = ctx.saved_tensors
        gx, dw3, db3, dw1, db1, dwl, dbl = cuda.wavenet_train_backward(
            gz, ctx.stash, lengths, w3, w1, w_last, ctx.drop_masks, **ctx.statics
        )
        ctx.stash = None
        return gx, None, dw3, db3, dw1, db1, dwl, dbl, None, None


def wavenet_stack_train(
    x, lengths, w3, b3, w1, b1, w_last, b_last, drop_masks,
    stages: Sequence[int],
    pooling_layers: Sequence[int],
    pooling_type: str = "max",
    leaky: bool = False,
    mm_dtype=None,
):
    """Differentiable stack: (z [B x T/2^p x C], lengths >> p).  The plain
    twin on a CPU tensor; the CUDA kernels on a CUDA tensor."""
    statics = dict(stages=tuple(int(d) for d in stages),
                   pooling_layers=tuple(int(p) for p in pooling_layers),
                   pooling_type=pooling_type, leaky=bool(leaky), mm_dtype=mm_dtype)
    if x.device.type == "cpu":
        return wavenet_stack_train_plain(
            x, lengths, w3, b3, w1, b1, w_last, b_last, drop_masks=drop_masks,
            **statics,
        )
    n_pools = sum(1 for p in statics["pooling_layers"] if p < len(stages))
    masks = None if drop_masks is None else tuple(drop_masks)
    z = WaveNetStackTrain.apply(x, lengths, w3, b3, w1, b1, w_last, b_last, masks,
                                statics)
    return z, lengths >> n_pools
