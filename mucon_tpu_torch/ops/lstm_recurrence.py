"""Two-direction masked LSTM recurrence (mucon_tpu/ops/lstm_pallas.py:33-124).

Inputs are time-major: xp [T, 2, B, 4H] (input projections with b_ih AND
b_hh folded in; direction 1 runs over the valid-prefix-reversed
sequence), m [T, B] (1.0 on valid frames; the state freezes at 0.0) and
w_hh [2, H, 4H].  Outputs: outs [T, 2, B, H] (written every step) and the
final h, c [2, B, H].  Gate order i, f, g, o (torch nn.LSTM).

* `bilstm_recurrence_plain` — plain PyTorch loop over T, the twin of
  `bilstm_recurrence_xla` (lstm_pallas.py:102).
* `bilstm_recurrence` — dispatch by device: CPU tensors take the plain
  version, CUDA tensors launch `csrc/bilstm.cu` or raise.
"""

from __future__ import annotations

import torch


def bilstm_recurrence_plain(xp, m, w_hh):
    T, _, B, H4 = xp.shape
    H = H4 // 4
    h = xp.new_zeros(2, B, H)
    c = xp.new_zeros(2, B, H)
    outs = xp.new_empty(T, 2, B, H)
    for t in range(T):
        gates = xp[t] + torch.bmm(h, w_hh)
        i, f, g, o = gates.split(H, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        mm = m[t][None, :, None]
        h = mm * h_new + (1 - mm) * h
        c = mm * c_new + (1 - mm) * c
        outs[t] = h
    return outs, h, c


def bilstm_recurrence(xp, m, w_hh):
    """`bilstm_recurrence_plain` on CPU tensors; the CUDA kernel on CUDA
    tensors."""
    if xp.device.type == "cpu":
        return bilstm_recurrence_plain(xp, m, w_hh)
    from mucon_tpu_torch import cuda

    return cuda.bilstm_recurrence(xp, m, w_hh)
