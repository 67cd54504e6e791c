"""The stack kernels' bf16-operand mode, stated in plain PyTorch.

With `tpu.kernel_mm_dtype=bfloat16` the JAX package's stack kernels feed
bf16 operands to every matrix product and accumulate in f32
(`_matmul_bt` / `_matmul_flat_T`, mucon_tpu/ops/wavenet_pallas_v2.py:44-63,
wavenet_train_pallas_v2.py:82-98): the product of two bf16 numbers is exact
in f32, so the product is "round both operands to bf16, then an f32
product".  The residual state, biases, pools, dropout and sums stay f32.
The CUDA kernels' mode (`csrc/mma_tf32.cuh`, `warp_gemm2<..., BF16>`)
rounds the same operands as they leave shared memory (`cvt.rn.bf16x2.f32`,
to nearest with ties to even, as `.to(torch.bfloat16)` rounds).

* `bf16_round` — x rounded to bf16 and back to f32.
* `matmul_bf16_plain` — a @ b on bf16-rounded operands, f32 product.
* `MatmulBF16` — the same product under autograd; its two gradient
  products (g b^T, and a^T g over the flattened rows) round their operands
  too, as the trainable stack's sweep does (wavenet_train_pallas_v3.py:
  241-270).  With `round_grads=False` the gradient is the f32 one of the
  unrounded operands: the JAX package's out-projection backward when the
  last layer pools (:504-515), which runs outside its kernel.
* `DotBF16` — a bf16-operand product with an f32 result outside the
  kernels (the in-projection, model.py:358-372), with the gradients JAX's
  autodiff gives it (rounded to bf16).
"""

from __future__ import annotations

import torch


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to bf16 (nearest, ties to even) and returned as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def matmul_bf16_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to bf16 first; the products are
    exact in f32 and are summed in f32."""
    return bf16_round(a) @ bf16_round(b)


class MatmulBF16(torch.autograd.Function):
    """a [..., K] @ b [K, N] on bf16-rounded operands, forward and (with
    `round_grads`) backward."""

    @staticmethod
    def forward(ctx, a, b, round_grads: bool = True):
        ctx.save_for_backward(a, b)
        ctx.round_grads = round_grads
        return matmul_bf16_plain(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        mm = matmul_bf16_plain if ctx.round_grads else torch.matmul
        ga = mm(g, b.t()) if ctx.needs_input_grad[0] else None
        gb = None
        if ctx.needs_input_grad[1]:
            gb = mm(a.reshape(-1, a.shape[-1]).t(), g.reshape(-1, g.shape[-1]))
        return ga, gb, None


def matmul_bf16(a: torch.Tensor, b: torch.Tensor, round_grads: bool = True) -> torch.Tensor:
    """`MatmulBF16` (differentiable, or plain under no_grad)."""
    return MatmulBF16.apply(a, b, round_grads)


class DotBF16(torch.autograd.Function):
    """`jnp.dot(a.astype(bf16), b.astype(bf16), preferred_element_type=f32)`
    under autograd: the JAX package's in-projection on bf16 operands
    (model.py:358-372).  Its product is `matmul_bf16_plain`, exact products
    summed in f32 and not rounded; its gradients are what JAX's transpose of
    that dot gives: each an f32 product of the unrounded cotangent with the
    other operand's bf16 value, rounded to bf16 (the operand's dtype)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return matmul_bf16_plain(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = bf16_round(g @ bf16_round(b).t()) if ctx.needs_input_grad[0] else None
        gb = None
        if ctx.needs_input_grad[1]:
            gb = bf16_round(bf16_round(a).reshape(-1, a.shape[-1]).t()
                            @ g.reshape(-1, g.shape[-1]))
        return ga, gb
