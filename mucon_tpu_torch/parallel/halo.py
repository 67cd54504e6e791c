"""Sequence-parallel halo exchange for dilated temporal convs
(mucon_tpu/parallel/halo.py).

Each rank of the mesh's "seq" group holds one contiguous block of the time
axis, [B x T_local x C], in rank order.  A kernel-3 dilated conv needs only
`dilation` frames of each neighbour, so each layer exchanges one halo with
the previous rank and one with the next (non-cyclic: a rank at either end
of the sequence gets zeros, the zero padding of a SAME conv), never an
all-gather.  The exchange is one `batch_isend_irecv` a shift, and its
backward sends the gradient's halo the other way, so a sequence-parallel
conv trains (the JAX package gets that from `ppermute`'s transpose).

Weights are replicated: each rank's gradient of `w` and `b` is its blocks'
share, which the caller sums over the "seq" group as the data-parallel
step averages over "data".  A halo must fit in one block:
|offset| <= T_local.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _exchange(x_local: torch.Tensor, offset: int, group) -> torch.Tensor:
    """out[:, t] = x[:, t + offset] of the global sequence, on this rank's
    block; zeros past either end."""
    d = abs(offset)
    me, n = dist.get_rank(group), dist.get_world_size(group)
    # offset > 0: every rank sends its first d rows back to rank - 1 and
    # appends the next rank's; offset < 0: its last d rows on to rank + 1
    send, to, frm = ((x_local[:, :d], me - 1, me + 1) if offset > 0
                     else (x_local[:, -d:], me + 1, me - 1))
    halo = torch.zeros_like(send)
    ops = []
    if 0 <= to < n:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), dist.get_global_rank(group, to),
                              group))
    if 0 <= frm < n:
        ops.append(dist.P2POp(dist.irecv, halo, dist.get_global_rank(group, frm), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if offset > 0:
        return torch.cat([x_local[:, d:], halo], dim=1)
    return torch.cat([halo, x_local[:, :-d]], dim=1)


class _HaloShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_local, offset, group):
        ctx.offset, ctx.group = offset, group
        return _exchange(x_local, offset, group)

    @staticmethod
    def backward(ctx, grad):
        # the adjoint of a zero-filled shift by +offset is the shift by -offset
        return _exchange(grad, -ctx.offset, ctx.group), None, None


def halo_shift(x_local: torch.Tensor, offset: int, group=None) -> torch.Tensor:
    """The per-block `shift_time` (out[t] = x[t + offset]) of a time-sharded
    [B x T_local x C] block, boundary rows fetched from the neighbours in
    `group` (halo.py:30-61); differentiable."""
    if offset == 0:
        return x_local
    if abs(offset) > x_local.shape[1]:
        raise ValueError(f"halo {abs(offset)} exceeds the local block of "
                         f"{x_local.shape[1]} frames")
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
