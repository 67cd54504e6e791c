"""Sequence-parallel shifts for dilated temporal convs
(mucon_tpu/parallel/halo.py).

Each rank of the mesh's "seq" group holds one contiguous block of the time
axis, [B x T_local x C], in rank order.  A kernel-3 dilated conv reads the
sequence shifted by -d and +d, so each shift fetches only the rows that lie
in other blocks, never an all-gather.  A shift by `offset` (out[t] =
x[t + offset] over the global sequence, zeros past either end, the zero
padding of a SAME conv) takes any offset:

* |offset| <= T_local: the rows of one neighbour;
* T_local < |offset| < T_global: the rows of rank +- k, at most two source
  ranks (the full-depth stack's dilations 128-1024 on pooled blocks);
* |offset| >= T_global: zeros, with no exchange.

The exchange is one batch of sends and receives a shift
(`transport.send_recv`: staged through the host on a gloo group of CUDA
tensors), and its backward sends the gradient back the way the rows came
(the shift by -offset), so a sequence-parallel conv trains (the JAX package
gets that from `ppermute`'s transpose).

Weights are replicated over "seq": each rank's gradient of `w` and `b` is
its block's share, which the caller sums over the "seq" group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mucon_tpu_torch.parallel import transport


def shift_plan(offset: int, t_local: int, me: int, n: int):
    """Where the rows of a shift by `offset` come from and go to, for rank
    `me` of `n` blocks of `t_local` rows.  Returns (recvs, sends): recvs
    [(source rank, src_lo, src_hi, out_lo)], sends [(destination rank, lo,
    hi)], ranks outside [0, n) dropped (their rows are zeros).  With q, r
    = divmod(offset, t_local), out rows [0, t_local - r) are the source
    rank me + q's rows [r, t_local), and out rows [t_local - r, t_local)
    the rank me + q + 1's rows [0, r)."""
    q, r = divmod(offset, t_local)
    L = t_local
    recvs = [(me + q, r, L, 0)] + ([(me + q + 1, 0, r, L - r)] if r else [])
    sends = [(me - q, r, L)] + ([(me - q - 1, 0, r)] if r else [])
    return ([p for p in recvs if 0 <= p[0] < n], [p for p in sends if 0 <= p[0] < n])


def _exchange(x_local: torch.Tensor, offset: int, group) -> torch.Tensor:
    """out[:, t] = x[:, t + offset] of the global sequence, on this rank's
    block; zeros past either end."""
    L = x_local.shape[1]
    me, n = dist.get_rank(group), dist.get_world_size(group)
    out = torch.zeros_like(x_local)
    if abs(offset) >= n * L:
        return out
    recvs, sends = shift_plan(offset, L, me, n)
    incoming = []
    for src, lo, hi, at in recvs:
        if src == me:
            out[:, at:at + hi - lo] = x_local[:, lo:hi]
        else:
            incoming.append((x_local.new_empty((x_local.shape[0], hi - lo,
                                                *x_local.shape[2:])), src, at))
    transport.send_recv([(x_local[:, lo:hi], dst) for dst, lo, hi in sends if dst != me],
                        [(buf, src) for buf, src, _ in incoming], group)
    for buf, _, at in incoming:
        out[:, at:at + buf.shape[1]] = buf
    return out


class _HaloShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_local, offset, group):
        ctx.offset, ctx.group = offset, group
        return _exchange(x_local, offset, group)

    @staticmethod
    def backward(ctx, grad):
        # the adjoint of a zero-filled shift by +offset is the shift by -offset
        return _exchange(grad.contiguous(), -ctx.offset, ctx.group), None, None


def halo_shift(x_local: torch.Tensor, offset: int, group=None) -> torch.Tensor:
    """The per-block `shift_time` (out[t] = x[t + offset]) of a time-sharded
    [B x T_local x C] block, rows fetched from the ranks of `group` that
    hold them (halo.py:30-61, for any offset); differentiable."""
    if offset == 0:
        return x_local
    return _HaloShift.apply(x_local, offset, group)


def dilated_conv3_sp(x_local, w, b, dilation: int, group=None):
    """Kernel-3 dilated conv of a time-sharded block (halo.py:64-75).
    w: [3 x C_in x C_out], b: [C_out], the packed layout of the models'
    `DilatedConv3`."""
    y = (halo_shift(x_local, -dilation, group) @ w[0] + x_local @ w[1]
         + halo_shift(x_local, dilation, group) @ w[2])
    return y + b[None, None, :]


def make_sp_dilated_conv(mesh, dilation: int, axis_name: str = "seq"):
    """conv(x_local, w, b): the dilated conv over the time blocks of the
    mesh's `axis_name` group, [B x T_local x C] in and out on each rank
    (halo.py:78-91)."""
    group = mesh.get_group(axis_name)

    def conv(x_local, w, b):
        return dilated_conv3_sp(x_local, w, b, dilation, group)

    return conv
