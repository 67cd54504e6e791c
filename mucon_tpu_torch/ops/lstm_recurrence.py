"""Two-direction masked LSTM recurrence (mucon_tpu/ops/lstm_pallas.py).

Inputs are time-major: xp [T, 2, B, 4H] (input projections with b_ih AND
b_hh folded in; direction 1 runs over the valid-prefix-reversed
sequence), m [T, B] (1.0 on valid frames; the state freezes at 0.0) and
w_hh [2, H, 4H].  Outputs: outs [T, 2, B, H] (written every step) and the
final h, c [2, B, H].  Gate order i, f, g, o (torch nn.LSTM).

* `bilstm_recurrence_plain` — plain PyTorch loop over T, the twin of
  `bilstm_recurrence_xla` (lstm_pallas.py:102); differentiable by autograd.
* `bilstm_recurrence` — eval dispatch by device: CPU tensors take the plain
  version, CUDA tensors launch `csrc/bilstm.cu` or raise.
* `BiLSTMRecurrenceTrain` — the trainable recurrence on the card
  (`bilstm_recurrence_train`, lstm_pallas.py:254-290): the forward kernel
  also stashes the cell trajectory, the backward kernel runs the reverse
  (dh, dc) chain and emits dxp, and the w_hh gradient is one einsum over
  the stashed h trajectory, outside the kernel as in the JAX package.
* `bilstm_recurrence_train` — train dispatch: the plain twin on CPU
  tensors, the Function on CUDA tensors.
"""

from __future__ import annotations

import torch


def bilstm_recurrence_plain(xp, m, w_hh, stash: bool = False):
    """-> (outs, h, c), and the cell trajectory cs [T, 2, B, H] last when
    `stash` (the twin of the train kernel's extra output)."""
    T, _, B, H4 = xp.shape
    H = H4 // 4
    h = xp.new_zeros(2, B, H)
    c = xp.new_zeros(2, B, H)
    outs, cs = [], []
    for t in range(T):
        gates = xp[t] + torch.bmm(h, w_hh)
        i, f, g, o = gates.split(H, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        mm = m[t][None, :, None]
        h = mm * h_new + (1 - mm) * h
        c = mm * c_new + (1 - mm) * c
        outs.append(h)
        cs.append(c)
    empty = xp.new_zeros(0, 2, B, H)
    outs = torch.stack(outs) if T else empty
    if stash:
        return outs, h, c, torch.stack(cs) if T else empty
    return outs, h, c


def bilstm_recurrence(xp, m, w_hh):
    """`bilstm_recurrence_plain` on CPU tensors; the CUDA kernel on CUDA
    tensors."""
    if xp.device.type == "cpu":
        return bilstm_recurrence_plain(xp, m, w_hh)
    from mucon_tpu_torch import cuda

    return cuda.bilstm_recurrence(xp, m, w_hh)


class BiLSTMRecurrenceTrain(torch.autograd.Function):
    """The recurrence with a kernel backward (lstm_pallas.py:265-287)."""

    @staticmethod
    def forward(ctx, xp, m, w_hh):
        from mucon_tpu_torch import cuda

        outs, h, c, cs = cuda.bilstm_train_forward(xp, m, w_hh)
        ctx.save_for_backward(xp, m, w_hh, outs, cs)
        return outs, h, c

    @staticmethod
    def backward(ctx, douts, dh, dc):
        from mucon_tpu_torch import cuda

        xp, m, w_hh, outs, cs = ctx.saved_tensors
        douts, dh, dc = (torch.zeros_like(ref) if g is None else g.contiguous()
                         for g, ref in ((douts, outs), (dh, cs[0]), (dc, cs[0])))
        dxp = cuda.bilstm_train_backward(xp, m, w_hh, outs, cs, douts, dh, dc)
        # the gates of step t consumed h_prev = outs[t - 1] (zeros at t = 0)
        h_prev = torch.cat([torch.zeros_like(outs[:1]), outs[:-1]])
        dw = torch.einsum("tdbh,tdbg->dhg", h_prev, dxp)
        return dxp, None, dw


def bilstm_recurrence_train(xp, m, w_hh):
    """Differentiable recurrence: the plain twin on CPU tensors, the CUDA
    kernels (forward with cell stash, reverse chain) on CUDA tensors."""
    if xp.device.type == "cpu":
        return bilstm_recurrence_plain(xp, m, w_hh)
    return BiLSTMRecurrenceTrain.apply(xp, m, w_hh)
