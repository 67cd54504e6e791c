"""LSTM cells and the masked (bi)directional encoder (mucon_tpu/models/lstm.py).

torch nn.LSTM conventions (gate order i, f, g, o; two bias vectors) with
the JAX package's layouts: w_ih [I, 4H], w_hh [H, 4H].  The input
projection for all timesteps is one matmul; only the h @ w_hh recurrence
is sequential.  For a bidirectional encoder on an f32 input it runs as one
kernel (`ops/lstm_recurrence.py`; in training its backward is a kernel
too) when its route is on; a unidirectional encoder, or another input
dtype, takes the plain loop, as the JAX package takes its scan
(lstm.py:135-145).  Each decision is logged once (`models/routing.py`).
Padded timesteps freeze the state, so the final (h, c) equal an
exact-length LSTM's.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from mucon_tpu_torch.models.layers import time_mask, torch_linear_init_
from mucon_tpu_torch.models.routing import log_route
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
        """One step; a bf16 x is promoted to the f32 weights' dtype, as JAX
        promotes it (the decoder's combine output under bf16 compute)."""
        return lstm_step(self.project_inputs(x), h, c, self.w_hh, self.b_hh)

    def project_inputs(self, xs):
        """[B x T x I] -> [B x T x 4H] input projection for all steps."""
        return xs.to(self.w_ih.dtype) @ self.w_ih + self.b_ih


def _reverse_valid(xs, lengths):
    """Reverse each video's valid prefix in place: out[t] = x[len-1-t]."""
    T = xs.shape[1]
    ids = torch.arange(T, device=xs.device)
    rev = torch.clamp(lengths.to(torch.int64)[:, None] - 1 - ids[None, :], 0, T - 1)
    return torch.gather(xs, 1, rev[:, :, None].expand(-1, -1, xs.shape[2]))


def _scan_direction(cell: LSTMCellParams, xs, m):
    """One direction over [B x T x I] with the state-freezing mask [B x T]
    (lstm.py:60-86): (outputs [B x T x H], (h_final, c_final))."""
    B, T, _ = xs.shape
    xp = cell.project_inputs(xs)
    h = c = xp.new_zeros(B, cell.w_hh.shape[0])
    outs = []
    for t in range(T):
        h_new, c_new = lstm_step(xp[:, t], h, c, cell.w_hh, cell.b_hh)
        mt = m[:, t, None]
        h = mt * h_new + (1 - mt) * h
        c = mt * c_new + (1 - mt) * c
        outs.append(h)
    out = torch.stack(outs, dim=1) if T else xp.new_zeros(B, 0, h.shape[1])
    return out, (h, c)


class MaskedBiLSTM(nn.Module):
    """Masked LSTM == torch nn.LSTM on exact-length inputs, bidirectional by
    default.  Returns outputs [B x T x 2H] (one direction: H; zero beyond
    each length) and the final (h, c) as [B x 2H] (H) each, forward then
    backward.

    Both directions run in one recurrence: the backward one over the
    valid-prefix-reversed input (lstm.py:183-236), with b_hh folded into
    the projections as the kernel takes them.  The parameters are f32; an
    input of another dtype is promoted by the input projection, as in
    JAX."""

    def __init__(self, input_size: int, hidden_size: int, bidirectional: bool = True):
        super().__init__()
        self.bidirectional = bidirectional
        self.fwd = LSTMCellParams(input_size, hidden_size)
        if bidirectional:
            self.bwd = LSTMCellParams(input_size, hidden_size)

    def uses_kernel(self, xs, use_kernel: bool, train: bool) -> bool:
        """The recurrence's route (lstm.py:135-170): its kernel when the
        route is on, the encoder is bidirectional and the input is f32."""
        if not use_kernel:
            return False
        B, T, _ = xs.shape
        if not self.bidirectional:
            log_route(f"bilstm Tz={T} B={B}: plain loop (kernel is 2-direction)")
            return False
        if xs.dtype != torch.float32:
            log_route(f"bilstm Tz={T} B={B}: plain loop (kernel is f32, got {xs.dtype})")
            return False
        log_route(f"bilstm Tz={T} B={B}: recurrence kernel"
                  f"{' (train, with its backward kernels)' if train else ''}")
        return True

    def forward(
        self, xs, lengths, use_kernels: bool = True, train: bool = False
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """`use_kernels`: the route of the recurrence (`KernelRoutes.lstm`, or
        `lstm_train` in train); `train` routes it to its differentiable
        kernel (the JAX package's `kernel_differentiable`, lstm.py:199-202)."""
        m = time_mask(xs.shape[1], lengths, xs.dtype)  # [B x T]
        kernel = self.uses_kernel(xs, use_kernels, train)
        if not self.bidirectional:
            out, (h, c) = _scan_direction(self.fwd, xs, m)
            return out * m[:, :, None], (h, c)
        xs_r = _reverse_valid(xs, lengths)
        b_hh = torch.stack([self.fwd.b_hh, self.bwd.b_hh])  # [2 x 4H]
        xp = torch.stack(
            [self.fwd.project_inputs(xs), self.bwd.project_inputs(xs_r)]
        ) + b_hh[:, None, None, :]  # [2 x B x T x 4H]
        xp = xp.permute(2, 0, 1, 3).contiguous()  # [T x 2 x B x 4H]
        w_hh = torch.stack([self.fwd.w_hh, self.bwd.w_hh])  # [2 x H x 4H]
        m_t = m.t().contiguous()
        if not kernel:
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
