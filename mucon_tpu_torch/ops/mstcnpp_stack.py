"""Fused MS-TCN++ first stage, eval (mucon_tpu/ops/mstcnpp_pallas.py).

Everything after the in-projection: L dual-dilation layers (a dilated
conv3 at d1 = 2^(L-1-i) and one at d2 = 2^i, their concat through a 2C -> C
1x1 split into top and bottom halves, ReLU, residual, mask) with max
pooling after `pooling_layers`, then the out-projection — no nonlinearity
before it — and the mask.

* `pack_mstcnpp_params` — the nine packed arrays of the JAX
  `pack_mstcnpp_params` (mstcnpp_pallas.py:29).
* `mstcnpp_stack_plain` — plain PyTorch, the twin of the TPU kernel
  `_mstcnpp_kernel` (mstcnpp_pallas.py:72) on the same packed weights.
* `mstcnpp_stack` — dispatch by device: a CPU tensor takes the plain twin,
  a CUDA tensor launches the hand-written kernel (`csrc/mstcnpp.cu`, one
  launch per layer plus one for the out-projection, on the tensor cores in
  error-compensated TF32, skipping the tiles past each video's length) or
  raises.

The TPU version's batch slicing (`plan_mstcnpp_slices`,
`mstcnpp_stack_pallas_sliced`) exists for the TPU's VMEM only and is not
ported: the kernel here holds one tile of rows per CTA at any batch.
Eval only, as in the JAX package: the stage trains as plain PyTorch.

`mm_dtype=torch.bfloat16` is the JAX kernel's `mm_dtype=jnp.bfloat16`
(mstcnpp_pallas.py:60-96): every product on bf16-rounded operands with f32
sums (`ops/bf16.py`), in the twin and in the kernel's bf16 mode.
"""

from __future__ import annotations

from typing import Sequence

import torch

from mucon_tpu_torch.models.layers import mask_time
from mucon_tpu_torch.models.temporal import pool2_time, shift_time
from mucon_tpu_torch.ops.bf16 import matmul_bf16_plain


def pack_mstcnpp_params(stage) -> tuple:
    """(w3a, b3a, w3b, b3b, w1t, w1b, b1, w_out, b_out) of an
    `MSTCNPPFirstStage`: w3a / w3b [L, 3, C, C] (the d1 and d2 convs),
    b3a / b3b [L, C], w1t / w1b [L, C, C] (the 2C -> C kernel's top and
    bottom halves), b1 [L, C], w_out [C, C], b_out [C].  The in-projection
    `Conv1x1_0` is not packed (it runs as a plain matmul before the stage)."""
    L = stage.num_layers
    conv = lambda j: getattr(stage, f"DilatedConv3_{j}")  # noqa: E731
    w3a = torch.stack([conv(2 * i).kernel for i in range(L)])
    b3a = torch.stack([conv(2 * i).bias for i in range(L)])
    w3b = torch.stack([conv(2 * i + 1).kernel for i in range(L)])
    b3b = torch.stack([conv(2 * i + 1).bias for i in range(L)])
    w1 = torch.stack([getattr(stage, f"Conv1x1_{i + 1}").kernel for i in range(L)])
    b1 = torch.stack([getattr(stage, f"Conv1x1_{i + 1}").bias for i in range(L)])
    C = w3a.shape[-1]
    out = getattr(stage, f"Conv1x1_{L + 1}")
    return (w3a, b3a, w3b, b3b, w1[:, :C].contiguous(), w1[:, C:].contiguous(), b1,
            out.kernel, out.bias)


def _mm(a, b):
    """Every product of the plain stage, in full f32.  (The CUDA kernel's are
    error-compensated TF32, `ops/tf32.py matmul_3xtf32_plain`; the tests swap
    that in here to hold the split to the f32 twin.)"""
    return a @ b


def _product(a, b, mm_dtype):
    """A product of the stage: `_mm` in f32 (mm_dtype None), or on
    bf16-rounded operands (mm_dtype torch.bfloat16)."""
    if mm_dtype is None:
        return _mm(a, b)
    if mm_dtype != torch.bfloat16:
        raise ValueError(f"mm_dtype must be None or torch.bfloat16, got {mm_dtype}")
    return matmul_bf16_plain(a, b)


def _conv3(x, d: int, w, b, mm_dtype=None):
    """shift(-d) @ w[0] + x @ w[1] + shift(+d) @ w[2] + b (models.temporal
    DilatedConv3's tap order)."""
    return (_product(shift_time(x, -d), w[0], mm_dtype) + _product(x, w[1], mm_dtype)
            + _product(shift_time(x, d), w[2], mm_dtype) + b)


def mstcnpp_stack_plain(
    x,  # [B x T x C] f32, after the in-projection (no ReLU)
    lengths,  # [B] int
    w3a, b3a, w3b, b3b, w1t, w1b, b1, w_out, b_out,
    pooling_layers: Sequence[int],
    mm_dtype=None,
):
    """Plain PyTorch stage. Returns (z [B x T/2^p x C], lengths >> p)."""
    L = w3a.shape[0]
    f = mask_time(x, lengths)
    ln = lengths
    for i in range(L):
        y1 = _conv3(f, 2 ** (L - 1 - i), w3a[i], b3a[i], mm_dtype)
        y2 = _conv3(f, 2 ** i, w3b[i], b3b[i], mm_dtype)
        y = _product(y1, w1t[i], mm_dtype) + _product(y2, w1b[i], mm_dtype) + b1[i]
        f = mask_time(torch.relu(y) + f, ln)
        if i in pooling_layers:
            f = pool2_time(f, "max")
            ln = ln // 2
            f = mask_time(f, ln)
    return mask_time(_product(f, w_out, mm_dtype) + b_out, ln), ln


def mstcnpp_stack(x, lengths, w3a, b3a, w3b, b3b, w1t, w1b, b1, w_out, b_out,
                  pooling_layers: Sequence[int], mm_dtype=None):
    """`mstcnpp_stack_plain` on a CPU tensor; the CUDA kernel on a CUDA
    tensor, any C (raises for an odd length at a pooling layer or packed
    weights that do not match x)."""
    args = (x, lengths, w3a, b3a, w3b, b3b, w1t, w1b, b1, w_out, b_out)
    pools = tuple(int(p) for p in pooling_layers)
    if x.device.type == "cpu":
        return mstcnpp_stack_plain(*args, pooling_layers=pools, mm_dtype=mm_dtype)
    from mucon_tpu_torch import cuda

    return cuda.mstcnpp_stack(*args, pooling_layers=pools, mm_dtype=mm_dtype)
