"""Fused mutual-consistency ("flint") loss (mucon_tpu/ops/mucon_loss_pallas.py).

The flint loss places one soft box mask per transcript segment over the
frames (from the softmaxed length logits), averages the frame logits
under each mask, and takes the NLL of each segment's word under the
log-softmax of its window.  The plain path materializes the [B x N x T]
masks; the kernel (`csrc/mucon_loss.cu`) builds them on chip, tile by
tile, and emits the per-video losses.

* `absolute_lengths` / `flint_prep` — the per-segment vectors: lengths
  T_i * softmax over the N_i real logits, and the kernel's placement
  (scale, xloc) and divisor (mucon_loss_pallas.py:147-159, with the
  widened-length quirk of :49-52).
* `mucon_flint_plain` — the twin of `_flint_batch_xla`
  (mucon_loss_pallas.py:37-66), batched over videos; also the plain
  path's flint term (`models/losses.py`) for every template.
* `MuconFlint` — forward by the kernel, backward by autograd of
  `mucon_flint_plain` (`_fused_bwd`, mucon_loss_pallas.py:221-234).
* `mucon_flint` — dispatch by device: the plain twin on CPU tensors, the
  Function (kernel forward) on CUDA tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mucon_tpu_torch.models.masks import create_masks_padded, mask_placement


def absolute_lengths(lengths_raw, n_len, t_valid):
    """(T_i * softmax of the first N_i length logits [B x N] (0 beyond N_i),
    the segment validity [B x N])."""
    N = lengths_raw.shape[1]
    valid = torch.arange(N, device=lengths_raw.device)[None, :] < n_len[:, None]
    logits = torch.where(valid, lengths_raw, float("-inf"))
    return t_valid.to(torch.float32)[:, None] * torch.softmax(logits, dim=1), valid


def _safe_div(widened, valid):
    return torch.where(valid, torch.clamp(widened, min=1e-12), 1.0)


def flint_prep(lengths_raw, n_len, t_valid, overlap: float):
    """The kernel's per-segment inputs (scale, xloc, divisor), each [B x N]."""
    abs_len, valid = absolute_lengths(lengths_raw, n_len, t_valid)
    scale, xloc, widened = mask_placement(t_valid, abs_len, valid, overlap)
    return scale, xloc, _safe_div(widened, valid)


def mucon_flint_plain(lengths_raw, segmentation, target, n_len, t_valid,
                      overlap: float = 0.0, weights: Optional[torch.Tensor] = None,
                      template: str = "box"):
    """Per-video flint losses [B]: lengths_raw [B x N] (the first N length
    logits), segmentation [B x T x M], target [B x N], n_len / t_valid [B],
    class weights [M] or None."""
    B, T, M = segmentation.shape
    abs_len, valid = absolute_lengths(lengths_raw, n_len, t_valid)
    masks = create_masks_padded(T, t_valid, abs_len, valid, overlap=overlap,
                                template=template)  # [B x N x T]
    div = _safe_div(abs_len * (1.0 + 2.0 * overlap), valid)
    window_lp = F.log_softmax(torch.bmm(masks, segmentation) / div[:, :, None], dim=2)
    tgt = torch.clamp(target, 0, M - 1)
    picked = -torch.gather(window_lp, 2, tgt[..., None])[..., 0]
    w = valid.to(picked.dtype) if weights is None else weights[tgt] * valid
    return torch.sum(picked * w, dim=1) / torch.clamp(torch.sum(w, dim=1), min=1e-12)


def _flint_forward(lengths_raw, segmentation, target, n_len, t_valid, overlap, weights):
    """The forward values: the plain twin on CPU tensors, kernel F (after
    the plain per-segment prep) on CUDA tensors."""
    with torch.no_grad():
        if segmentation.device.type == "cpu":
            return mucon_flint_plain(lengths_raw, segmentation, target, n_len, t_valid,
                                     overlap, weights)
        from mucon_tpu_torch import cuda

        scale, xloc, sdiv = flint_prep(lengths_raw, n_len, t_valid, overlap)
        return cuda.mucon_flint(scale, xloc, sdiv, segmentation.contiguous(), target,
                                n_len, t_valid, weights)


class MuconFlint(torch.autograd.Function):
    """`mucon_flint_fused` (mucon_loss_pallas.py:198): the forward is the
    kernel, the backward autograd of the plain closed form.  `weights` is
    an [M] tensor; with `use_weights` False it is not read and its
    gradient is zeros."""

    @staticmethod
    def forward(ctx, lengths_raw, segmentation, target, n_len, t_valid, overlap: float,
                use_weights: bool, weights):
        ctx.save_for_backward(lengths_raw, segmentation, target, n_len, t_valid, weights)
        ctx.overlap, ctx.use_weights = overlap, use_weights
        return _flint_forward(lengths_raw, segmentation, target, n_len, t_valid, overlap,
                              weights if use_weights else None)

    @staticmethod
    def backward(ctx, g):
        lengths_raw, segmentation, target, n_len, t_valid, weights = ctx.saved_tensors
        with torch.enable_grad():
            xs = [t.detach().requires_grad_() for t in (lengths_raw, segmentation, weights)]
            out = mucon_flint_plain(xs[0], xs[1], target, n_len, t_valid, ctx.overlap,
                                    xs[2] if ctx.use_weights else None)
            d_lr, d_seg, d_w = torch.autograd.grad(out, xs, g, allow_unused=True)
        if d_w is None:
            d_w = torch.zeros_like(weights)
        return d_lr, d_seg, None, None, None, None, None, d_w


def mucon_flint(lengths_raw, segmentation, target, n_len, t_valid, overlap: float = 0.0,
                weights: Optional[torch.Tensor] = None):
    """Differentiable per-video flint losses [B] of the box template: the
    plain twin on CPU tensors, `MuconFlint` (kernel F) on CUDA tensors."""
    if segmentation.device.type == "cpu":
        return mucon_flint_plain(lengths_raw, segmentation, target, n_len, t_valid,
                                 overlap, weights)
    use_weights = weights is not None
    if not use_weights:
        weights = segmentation.new_ones(segmentation.shape[2])
    return MuconFlint.apply(lengths_raw, segmentation, target, n_len, t_valid,
                            float(overlap), use_weights, weights)
