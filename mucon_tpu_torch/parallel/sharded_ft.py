"""The sequence- and channel-parallel backbone: the `ft` of the JAX
package's GSPMD path on a mesh with "seq" or "model" above 1
(mucon_tpu/parallel/mesh.py:68-98, 250-377), written out by hand.

A rank of data row r holds [B_r x t x D] features, t = T / n_seq frames of
one time block, and the columns of every `ft` leaf that `shard_params`
gave it.  Each layer of `WaveNetBlock`, `MSTCNPPFirstStage` and `NoFt`
runs as the plain module does, with three changes:

* a dilated conv's shifted reads come from the ranks that hold the rows
  (`halo.halo_shift`, any offset), and `mask_time` uses the block's global
  time offset; `pool2_time` pools inside the block, so T must be a
  multiple of 2^(pools) * n_seq (`check_time_split`);
* each layer computes its own output columns; where the next op needs all
  channels the columns are all-gathered over "model" (`gather_model`,
  whose backward takes this rank's slice of the gradient: downstream of a
  gather every rank holds the same gradient), and the replicated input of
  a column-parallel product goes through `copy_to_model`, whose backward
  sums the ranks' partial gradients over "model";
* each layer's dropout mask is the one a one-rank run draws at the data
  rank's full [B_r x t_i x C], sliced to the block and the columns.

The output is gathered over "model" and "seq" into the data rank's
[B_r x Tz x C]; GroupNorm and everything after run replicated.  The stack
kernels cannot exchange rows or columns between layers, so this is the
plain path on every route (`models/routing.py`).  With the model axis at 1
no column collective runs; with the seq axis at 1 no shift leaves the
rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist

from mucon_tpu_torch.models.temporal import dropped, nonlinearity, pool2_time, shift_time
from mucon_tpu_torch.parallel import transport
from mucon_tpu_torch.parallel.halo import halo_shift
from mucon_tpu_torch.parallel.mesh import mesh_shape, model_columns


class _GatherColumns(torch.autograd.Function):
    """All-gather over a group on `dim`; the backward takes this rank's
    slice of the gradient, which every rank holds whole and equal."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        return torch.cat(transport.all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


class _CopyToModel(torch.autograd.Function):
    """The identity on a tensor replicated over a group; the backward sums
    the ranks' gradients over it (each rank's product used its own
    columns of the weights)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


@dataclass
class Layout:
    """A rank's place on the mesh for the backbone: its seq block and model
    columns and the two groups."""

    n_seq: int
    n_model: int
    seq_rank: int
    seq_group: object
    model_group: object
    mesh: object

    @classmethod
    def of(cls, mesh) -> "Layout":
        shape = mesh_shape(mesh)
        return cls(shape["seq"], shape["model"], mesh.get_local_rank("seq"),
                   mesh.get_group("seq"), mesh.get_group("model"), mesh)

    def gather_model(self, x):
        if self.n_model == 1:
            return x
        return _GatherColumns.apply(x, x.dim() - 1, self.model_group)

    def copy_to_model(self, x):
        return x if self.n_model == 1 else _CopyToModel.apply(x, self.model_group)

    def shift(self, x, offset: int):
        if self.n_seq == 1:
            return shift_time(x, offset)
        return halo_shift(x, offset, self.seq_group)

    def gather_all(self, x):
        """[B x t x c] columns of a time block -> [B x T x C] on every rank
        of the data row."""
        x = self.gather_model(x)
        if self.n_seq == 1:
            return x
        return _GatherColumns.apply(x, 1, self.seq_group)


def pooled_layers(ft) -> int:
    """How many times the backbone halves the time axis."""
    n_layers = ft.num_layers if hasattr(ft, "num_layers") else len(getattr(ft, "stages", ()))
    return sum(1 for p in getattr(ft, "pooling_layers", ()) if p < n_layers)


def check_time_split(t_pad: int, ft, n_seq: int) -> None:
    """T_pad must be a multiple of 2^(pools) * n_seq, so that every pooled
    block stays whole on its rank; else a `ValueError` that names the rule."""
    unit = 2 ** pooled_layers(ft) * n_seq
    if t_pad % unit:
        raise ValueError(f"T_pad {t_pad} must be a multiple of 2^(pooling layers) * seq = "
                         f"2^{pooled_layers(ft)} * {n_seq} = {unit} on this mesh, so that "
                         "every pooled time block stays whole (set tpu.pad_multiple)")


def _mask(x, lengths, offset: int):
    """`mask_time` of a time block that starts at global frame `offset`."""
    ids = offset + torch.arange(x.shape[1], device=lengths.device)
    return x * (ids[None, :] < lengths[:, None]).to(x.dtype)[:, :, None]


def _leaf(module):
    """This rank's columns of a backbone layer's (kernel, bias), cast to
    its compute dtype."""
    return module.kernel.to(module.dtype), module.bias.to(module.dtype)


def _dense(x, pk):
    k, b = pk
    return x.to(k.dtype) @ k + b


def _conv3(lay: Layout, x, module, pk):
    """`DilatedConv3` of a time block: the products shift (a shift along
    time commutes with the product over channels), so each rank exchanges
    only its own columns."""
    k, b = pk
    x, d = x.to(k.dtype), module.dilation
    return lay.shift(x @ k[0], -d) + x @ k[1] + lay.shift(x @ k[2], d) + b


def _mask_block(mask, offset: int, t: int, cols: Optional[slice]):
    if mask is None:
        return None
    mask = mask[:, offset:offset + t]
    return mask if cols is None else mask[..., cols]


def sharded_ft_forward(net, feats, lengths, mesh, drop_masks: Optional[List] = None):
    """(z [B_r x Tz x C], Tz lengths) of the backbone `net.ft` run on this
    rank's time block `feats` [B_r x t x D] (the compute dtype's cast
    included), gathered over "model" and "seq"; `lengths` are the videos'
    global frame counts, `drop_masks` the one-rank run's per-layer masks
    (or None)."""
    lay = Layout.of(mesh)
    ft = net.ft
    t = feats.shape[1]
    check_time_split(t * lay.n_seq, ft, lay.n_seq)
    if getattr(net, "model_shards", 1) != lay.n_model:
        raise ValueError(f"the net is split over {getattr(net, 'model_shards', 1)} model "
                         f"ranks, the mesh has {lay.n_model}: split it with "
                         "parallel.mesh.shard_params first")
    x = feats.to(net.dtype)
    off = lay.seq_rank * t
    width = ft.Conv1x1_0.kernel.shape[-1] * lay.n_model
    cols = model_columns(mesh, width) if lay.n_model > 1 else None

    def own(v):
        return v if cols is None else v[..., cols]

    def masks_at(i, t_i, off_i):
        m = None if drop_masks is None else drop_masks[i]
        return _mask_block(m, off_i, t_i, cols)

    if net.ft_type == "wavenet":
        x = lay.gather_model(_mask(nonlinearity(_dense(x, _leaf(ft.Conv1x1_0)), ft.leaky),
                                   lengths, off))
        for i in range(len(ft.stages)):
            layer = getattr(ft, f"WaveNetLayer_{i}")
            xr = lay.copy_to_model(x)
            y = _conv3(lay, xr, layer.DilatedConv3_0, _leaf(layer.DilatedConv3_0))
            h = lay.gather_model(nonlinearity(y, ft.leaky))
            z = _dense(lay.copy_to_model(h), _leaf(layer.Conv1x1_0))
            z = dropped(z, masks_at(i, x.shape[1], off))
            x = lay.gather_model(_mask(z + own(xr), lengths, off))
            if i in ft.pooling_layers:
                x = pool2_time(x, ft.pooling_type)
                lengths, off = lengths // 2, off // 2
                x = _mask(x, lengths, off)
        x = _dense(lay.copy_to_model(nonlinearity(x, ft.leaky)), _leaf(ft.Conv1x1_1))
    elif net.ft_type == "mstcnpp":
        L = ft.num_layers
        x = lay.gather_model(_mask(_dense(x, _leaf(ft.Conv1x1_0)), lengths, off))
        for i in range(L):
            xr = lay.copy_to_model(x)
            c1, c2 = getattr(ft, f"DilatedConv3_{2 * i}"), getattr(ft, f"DilatedConv3_{2 * i + 1}")
            y1 = lay.gather_model(_conv3(lay, xr, c1, _leaf(c1)))
            y2 = lay.gather_model(_conv3(lay, xr, c2, _leaf(c2)))
            y = torch.relu(_dense(lay.copy_to_model(torch.cat([y1, y2], dim=-1)),
                                  _leaf(getattr(ft, f"Conv1x1_{i + 1}"))))
            y = dropped(y, masks_at(i, x.shape[1], off))
            x = lay.gather_model(_mask(y + own(xr), lengths, off))
            if i in ft.pooling_layers:
                x = pool2_time(x, "max")
                lengths, off = lengths // 2, off // 2
                x = _mask(x, lengths, off)
        x = _dense(lay.copy_to_model(x), _leaf(getattr(ft, f"Conv1x1_{L + 1}")))
    elif net.ft_type == "noft":
        x = _dense(x, _leaf(ft.Conv1x1_0))
    else:
        raise ValueError(f"Invalid ft type ({net.ft_type})")
    return lay.gather_all(_mask(x, lengths, off)), lengths
