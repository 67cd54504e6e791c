"""Error-compensated TF32 ("3xTF32"), stated in plain PyTorch.

The MS-TCN++ stage's CUDA kernel (`csrc/mstcnpp.cu`, `csrc/mma_tf32.cuh`)
runs its products on the tensor cores, whose f32 path is TF32: an 8-bit
exponent and a 10-bit mantissa.  One TF32 product loses about 5e-4
relative, too much for 11 residual layers held to 1e-4.  So each f32
operand is split in two TF32 numbers, x = hi + lo up to 2^-21 |x|, and a
product is three tensor-core products accumulated in f32:

    a b  ~=  lo_a hi_b + hi_a lo_b + hi_a hi_b        (small terms first)

* `tf32_round` — round to nearest, ties away from zero, to a 10-bit
  mantissa, by bit arithmetic on the int32 view (as `cvt.rna.tf32.f32`).
* `tf32_split` — (hi, lo) with hi = tf32(x), lo = tf32(x - hi).
* `matmul_3xtf32_plain` — the three products with f32 accumulation: what
  the kernel's inner product computes, up to the order of the sum.
* `Matmul3xTF32` — the same product under autograd, its two gradient
  products (g b^T, and a^T g over the flattened rows) in 3xTF32 too: the
  arithmetic of the trainable stack's forward and sweep kernels
  (`csrc/wavenet_train.cu`).  The bit operations of `tf32_round` carry no
  gradient, so the plain product alone cannot be differentiated.

The stage's plain twin (`ops/mstcnpp_stack.py mstcnpp_stack_plain`) stays
full f32; this module is what the tests hold the split against.
"""

from __future__ import annotations

import torch

_HALF = 0x1000  # half a unit of the last kept mantissa bit (13 bits are dropped)
_KEEP = -0x2000  # ~0x1FFF as a signed int32: clears the 13 dropped bits


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32's 10-bit mantissa, to nearest with ties away
    from zero (sign-magnitude: add half, clear the low 13 bits).  inf and nan
    pass through; a value that rounds past the largest finite one becomes
    inf, as the carry into the exponent makes it."""
    if x.dtype != torch.float32:
        raise ValueError(f"tf32_round takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + _HALF) & _KEEP).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def tf32_split(x: torch.Tensor) -> tuple:
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi); x - hi is exact in f32."""
    hi = tf32_round(x)
    # x - hi is nan for an infinite x: lo is 0 there and hi carries x
    lo = tf32_round(torch.where(torch.isfinite(hi), x - hi, torch.zeros_like(x)))
    return hi, lo


def matmul_3xtf32_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from the split operands, three products accumulated in f32,
    small terms first."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


class Matmul3xTF32(torch.autograd.Function):
    """a [..., K] @ b [K, N] in 3xTF32, forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return matmul_3xtf32_plain(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = matmul_3xtf32_plain(g, b.t().contiguous()) if ctx.needs_input_grad[0] else None
        gb = None
        if ctx.needs_input_grad[1]:
            gb = matmul_3xtf32_plain(a.reshape(-1, a.shape[-1]).t().contiguous(),
                                     g.reshape(-1, g.shape[-1]))
        return ga, gb
