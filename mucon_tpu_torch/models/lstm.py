"""LSTM cells and the masked bidirectional encoder (mucon_tpu/models/lstm.py).

torch nn.LSTM conventions (gate order i, f, g, o; two bias vectors) with
the JAX package's layouts: w_ih [I, 4H], w_hh [H, 4H].  The input
projection for all timesteps is one matmul; only the h @ w_hh recurrence
is sequential, and it runs as one kernel (`ops/lstm_recurrence.py`); in
training its backward is a kernel too.
Padded timesteps freeze the state, so the final (h, c) equal an
exact-length LSTM's.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from mucon_tpu_torch.models.layers import time_mask, torch_linear_init_
from mucon_tpu_torch.ops.lstm_recurrence import (
    bilstm_recurrence,
    bilstm_recurrence_plain,
    bilstm_recurrence_train,
)


def lstm_step(x_proj, h, c, w_hh, b_hh):
    """One LSTM step given a precomputed input projection [B x 4H]."""
    gates = x_proj + h @ w_hh + b_hh
    i, f, g, o = gates.split(gates.shape[-1] // 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


class LSTMCellParams(nn.Module):
    """Parameter container for one torch-layout LSTM cell."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        H = hidden_size
        self.w_ih = nn.Parameter(torch.empty(input_size, 4 * H))
        self.w_hh = nn.Parameter(torch.empty(H, 4 * H))
        self.b_ih = nn.Parameter(torch.empty(4 * H))
        self.b_hh = nn.Parameter(torch.empty(4 * H))

    def reset_parameters(self, generator: torch.Generator):
        for p in (self.w_ih, self.w_hh, self.b_ih, self.b_hh):
            torch_linear_init_(p, self.w_hh.shape[0], generator)

    def forward(self, x, h, c):
        return lstm_step(x @ self.w_ih + self.b_ih, h, c, self.w_hh, self.b_hh)

    def project_inputs(self, xs):
        """[B x T x I] -> [B x T x 4H] input projection for all steps."""
        return xs @ self.w_ih + self.b_ih


def _reverse_valid(xs, lengths):
    """Reverse each video's valid prefix in place: out[t] = x[len-1-t]."""
    T = xs.shape[1]
    ids = torch.arange(T, device=xs.device)
    rev = torch.clamp(lengths.to(torch.int64)[:, None] - 1 - ids[None, :], 0, T - 1)
    return torch.gather(xs, 1, rev[:, :, None].expand(-1, -1, xs.shape[2]))


class MaskedBiLSTM(nn.Module):
    """Bidirectional masked LSTM == torch nn.LSTM(bidirectional=True) on
    exact-length inputs.  Returns outputs [B x T x 2H] (zero beyond each
    length) and the final (h, c) as [B x 2H] each, forward then backward.

    Both directions run in one recurrence: the backward one over the
    valid-prefix-reversed input (lstm.py:183-236), with b_hh folded into
    the projections as the kernel takes them."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.fwd = LSTMCellParams(input_size, hidden_size)
        self.bwd = LSTMCellParams(input_size, hidden_size)

    def forward(
        self, xs, lengths, use_kernels: bool = True, train: bool = False
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """`train` routes the recurrence to its differentiable kernel (the
        JAX package's `kernel_differentiable`, lstm.py:199-202)."""
        m = time_mask(xs.shape[1], lengths, xs.dtype)  # [B x T]
        xs_r = _reverse_valid(xs, lengths)
        b_hh = torch.stack([self.fwd.b_hh, self.bwd.b_hh])  # [2 x 4H]
        xp = torch.stack(
            [self.fwd.project_inputs(xs), self.bwd.project_inputs(xs_r)]
        ) + b_hh[:, None, None, :]  # [2 x B x T x 4H]
        xp = xp.permute(2, 0, 1, 3).contiguous()  # [T x 2 x B x 4H]
        w_hh = torch.stack([self.fwd.w_hh, self.bwd.w_hh])  # [2 x H x 4H]
        m_t = m.t().contiguous()
        if not use_kernels:
            recurrence = bilstm_recurrence_plain
        else:
            recurrence = bilstm_recurrence_train if train else bilstm_recurrence
        outs, hc, cc = recurrence(xp, m_t, w_hh)
        out_f = outs[:, 0].transpose(0, 1)
        out_b = _reverse_valid(outs[:, 1].transpose(0, 1), lengths)
        out = torch.cat([out_f, out_b], dim=-1) * m[:, :, None]
        h = torch.cat([hc[0], hc[1]], dim=-1)
        c = torch.cat([cc[0], cc[1]], dim=-1)
        return out, (h, c)
