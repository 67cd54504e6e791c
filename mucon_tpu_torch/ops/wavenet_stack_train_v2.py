"""Trainable WaveNet stack, v2 (mucon_tpu/ops/wavenet_train_pallas_v2.py).

The same function as `ops/wavenet_stack_train.py` (v3) with max pooling,
computed the v2 way: the forward and the backward sweep each run as one
program per chunk of layers, and the sweep recomputes each pooled layer's
pre-pool output from the stash (layer inputs and nonlin(z)) to route the
pool's gradient to the first maximum of each pair.

* `chunk_bounds`, `fwd_chunks` — the JAX `_chunk_bounds` (:310) and
  `_fwd_chunks` (:474): contiguous [lo, hi) layer spans; one forward
  program without dropout, otherwise as many as the sweep.
* `WaveNetStackTrainV2` — a `torch.autograd.Function` over the two
  hand-written kernels of `csrc/wavenet_train_v2.cu` (one cooperative
  launch per chunk each), which run the v3 kernels' tile bodies on their
  weight chunks: z and every gradient equal v3's bit for bit.
* `wavenet_stack_train_v2` — dispatch by device: a CPU tensor takes the
  plain twin `wavenet_stack_train_plain` with max pooling, a CUDA tensor the
  Function (which raises on what the kernels do not take).

`mm_dtype=torch.bfloat16` is the JAX v2 kernel's `mm_dtype=jnp.bfloat16`
(wavenet_train_pallas_v2.py:82-97, :444-467): every product on bf16-rounded
operands with f32 sums, the out-projection's gradient products too (v3
takes those in f32 when the last layer pools; v2 does not): the twin with
`round_proj_grads=True`, the kernels' bf16 mode.

The dropout masks are inputs (one [B x t_i x C] tensor per layer, or None);
the JAX version draws them by threefry from a seed, which the port has no
counterpart of.  The TPU version's VMEM byte-budget split of the chunks
(`_chunk_bounds_budget` :326) is the TPU's memory limit and is not ported:
the chunks here are the count-based bounds.  v2 pools by max only (its
forward uses `jnp.max` unconditionally).
"""

from __future__ import annotations

from typing import Sequence

import torch

from mucon_tpu_torch.models.layers import mask_time
from mucon_tpu_torch.ops.wavenet_stack_train import wavenet_stack_train_plain


def chunk_bounds(L: int, n_chunks: int):
    """Split layers 0..L-1 into n_chunks contiguous [lo, hi) spans."""
    n_chunks = max(1, min(n_chunks, L))
    size = -(-L // n_chunks)
    return [(lo, min(lo + size, L)) for lo in range(0, L, size)]


def fwd_chunks(drop_rate: float, sweep_chunks: int, fwd_chunks: int) -> int:
    """One forward program without dropout; with dropout `fwd_chunks`, or
    `sweep_chunks` when it is 0."""
    if drop_rate == 0.0:
        return 1
    return max(1, fwd_chunks) if fwd_chunks else max(1, sweep_chunks)


_fwd_chunk_count = fwd_chunks  # for `wavenet_stack_train_v2`, whose argument shadows it


class WaveNetStackTrainV2(torch.autograd.Function):
    """The v2 stack on the card: forward and backward are CUDA kernels."""

    @staticmethod
    def forward(ctx, x, lengths, w3, b3, w1, b1, w_last, b_last, drop_masks, statics):
        from mucon_tpu_torch import cuda

        x = mask_time(x, lengths).contiguous()
        kw = dict(stages=statics["stages"], pooling_layers=statics["pooling_layers"],
                  leaky=statics["leaky"], mm_dtype=statics["mm_dtype"])
        z, stash = cuda.wavenet_train_v2_forward(
            x, lengths, w3, b3, w1, b1, w_last, b_last, drop_masks,
            bounds=statics["fwd_bounds"], **kw,
        )
        ctx.save_for_backward(lengths, w3, w1, b1, w_last)
        ctx.stash, ctx.drop_masks, ctx.kw = stash, drop_masks, kw
        ctx.sweep_bounds = statics["sweep_bounds"]
        return z

    @staticmethod
    def backward(ctx, gz):
        from mucon_tpu_torch import cuda

        lengths, w3, w1, b1, w_last = ctx.saved_tensors
        gx, dw3, db3, dw1, db1, dwl, dbl = cuda.wavenet_train_v2_backward(
            gz, ctx.stash, lengths, w3, w1, b1, w_last, ctx.drop_masks,
            bounds=ctx.sweep_bounds, **ctx.kw,
        )
        ctx.stash = None
        return gx, None, dw3, db3, dw1, db1, dwl, dbl, None, None


def wavenet_stack_train_v2(
    x, lengths, w3, b3, w1, b1, w_last, b_last, drop_masks,
    stages: Sequence[int],
    pooling_layers: Sequence[int],
    leaky: bool = False,
    sweep_chunks: int = 3,
    fwd_chunks: int = 0,
    mm_dtype=None,
):
    """Differentiable stack with max pooling: (z [B x T/2^p x C],
    lengths >> p).  The plain twin on a CPU tensor; the CUDA kernels on a
    CUDA tensor, the forward in `fwd_chunks(...)` launches and the sweep in
    `sweep_chunks` (`mm_dtype=torch.bfloat16`: the bf16-operand mode)."""
    stages = tuple(int(d) for d in stages)
    pools = tuple(int(p) for p in pooling_layers)
    if x.device.type == "cpu":
        return wavenet_stack_train_plain(
            x, lengths, w3, b3, w1, b1, w_last, b_last, drop_masks=drop_masks,
            stages=stages, pooling_layers=pools, pooling_type="max", leaky=bool(leaky),
            mm_dtype=mm_dtype, round_proj_grads=True if mm_dtype is not None else None,
        )
    L = len(stages)
    masks = None if drop_masks is None else tuple(drop_masks)
    # any positive rate: the masks are given, not drawn
    n_fwd = _fwd_chunk_count(0.0 if masks is None else 1.0, sweep_chunks, fwd_chunks)
    statics = dict(stages=stages, pooling_layers=pools, leaky=bool(leaky), mm_dtype=mm_dtype,
                   fwd_bounds=chunk_bounds(L, n_fwd),
                   sweep_bounds=chunk_bounds(L, sweep_chunks))
    z = WaveNetStackTrainV2.apply(x, lengths, w3, b3, w1, b1, w_last, b_last, masks, statics)
    return z, lengths >> sum(1 for p in pools if p < L)
