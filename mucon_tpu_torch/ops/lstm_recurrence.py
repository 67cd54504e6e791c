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
* `BiLSTMRecurrenceTrain` — the trainable recurrence with its own backward
  (`bilstm_recurrence_train`, lstm_pallas.py:254-290): the forward also
  stashes the cell trajectory; the backward is a parallel coefficient pass
  over all steps (the gate replay is not sequential: every step's input
  state is in the stash), the sequential (dh, dc) chain that emits dxp, and
  the w_hh gradient as one einsum over the stashed h trajectory, outside
  the kernels as in the JAX package.  It dispatches by device: CUDA tensors
  launch `csrc/bilstm.cu`'s kernels or raise, CPU tensors take the plain
  twins below.
* `bilstm_bwd_coefs_plain`, `bilstm_bwd_chain_plain` — the plain twins of
  the backward's two kernels.

The twins take the kernels' split order as an option: `k_groups=(NK, KC)`
sums each step's h w_hh as NK partial products over k-rows [g KC,
(g + 1) KC), added in group order, then xp (the forward and the
coefficient pass, `cuda.bilstm_fwd_plan`); `row_groups=GPQ` sums the
chain's dgate w_hh^T as partial products over gate rows [q GPQ,
(q + 1) GPQ) in group order (`cuda.bilstm_chain_plan`).  Above H = 256
these orders are the persistent kernels' (`cuda.bilstm_persistent_order`, a
function of H alone).  Which CTA holds a unit (of a cluster, or of the
persistent kernels' grid over the whole card) changes no sum.
* `bilstm_recurrence_train` — train dispatch: autograd of the plain
  recurrence on CPU tensors, the Function on CUDA tensors.
"""

from __future__ import annotations

import torch


def _grouped(a, w, size: int):
    """a @ w (batched) as partial products over the contracted dimension in
    groups of `size`, added in group order."""
    K = w.shape[-2]
    out = torch.bmm(a[..., :size], w[:, :size])
    for k0 in range(size, K, size):
        out = out + torch.bmm(a[..., k0:k0 + size], w[:, k0:k0 + size])
    return out


def _gate_product(h, w_hh, k_groups):
    return torch.bmm(h, w_hh) if k_groups is None else _grouped(h, w_hh, k_groups[1])


def bilstm_recurrence_plain(xp, m, w_hh, stash: bool = False, k_groups=None):
    """-> (outs, h, c), and the cell trajectory cs [T, 2, B, H] last when
    `stash` (the twin of the train kernel's extra output); `k_groups` (NK,
    KC): the forward kernel's sum order."""
    T, _, B, H4 = xp.shape
    H = H4 // 4
    h = xp.new_zeros(2, B, H)
    c = xp.new_zeros(2, B, H)
    outs, cs = [], []
    for t in range(T):
        gates = xp[t] + _gate_product(h, w_hh, k_groups)
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


def bilstm_bwd_coefs_plain(xp, m, w_hh, outs, cs, k_groups=None):
    """The six factors of the reverse chain for every step at once,
    coefs [6, T, 2, B, H] = (A, Ci, Cf, Cg, Co, F), from the stash: step t
    consumed h_prev = outs[t - 1] and c_prev = cs[t - 1] (zeros at t = 0), so
    its gates are one batched product.  With tc = tanh(f c_prev + i g):
    A = m o (1 - tc^2), Ci = g i (1 - i), Cf = c_prev f (1 - f),
    Cg = i (1 - g^2), Co = m tc o (1 - o), F = f.  `k_groups`: the forward
    kernel's sum order, which the coefficient pass keeps."""
    T, _, B, H = outs.shape
    h_prev = torch.cat([torch.zeros_like(outs[:1]), outs[:-1]])
    c_prev = torch.cat([torch.zeros_like(cs[:1]), cs[:-1]])
    if k_groups is None:
        gates = xp + torch.einsum("tdbh,dhg->tdbg", h_prev, w_hh)
    else:  # the directions as the batch, the steps and videos as rows
        rows = h_prev.permute(1, 0, 2, 3).reshape(2, T * B, H)
        prod = _grouped(rows, w_hh, k_groups[1]).reshape(2, T, B, 4 * H).permute(1, 0, 2, 3)
        gates = xp + prod
    i, f, g, o = gates.split(H, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    tc = torch.tanh(f * c_prev + i * g)
    mm = m[:, None, :, None]
    return torch.stack([mm * o * (1 - tc * tc), g * i * (1 - i), c_prev * f * (1 - f),
                        i * (1 - g * g), mm * tc * o * (1 - o), f])


def bilstm_bwd_chain_plain(coefs, m, w_hh, douts, dh, dc, row_groups=None):
    """The sequential pass: dxp [T, 2, B, 4H] from the factors and the
    cotangents of (outs, h_fin, c_fin) — the arithmetic of the JAX reverse
    kernel (lstm_pallas.py:212-233), regrouped around the factors.  A padded
    step (m = 0) emits dgate = 0 and passes dh + douts[t] and dc on
    unchanged.  `row_groups` (GPQ): the chain kernel's sum order."""
    T = douts.shape[0]
    w_t = w_hh.transpose(1, 2)  # [2, 4H, H]
    dxp = [None] * T
    for t in reversed(range(T)):
        a, ci, cf, cg, co, f = coefs[:, t]
        mm = m[t][None, :, None]
        dht = dh + douts[t]
        dct = dht * a + mm * dc
        dgate = torch.cat([dct * ci, dct * cf, dct * cg, dht * co], dim=-1)
        dxp[t] = dgate
        dc = dct * f + (1 - mm) * dc
        prod = torch.bmm(dgate, w_t) if row_groups is None else _grouped(dgate, w_t, row_groups)
        dh = prod + (1 - mm) * dht
    return torch.stack(dxp) if T else douts.new_zeros(0, 2, douts.shape[2], w_hh.shape[2])


def _train_forward(xp, m, w_hh):
    if xp.device.type == "cpu":
        return bilstm_recurrence_plain(xp, m, w_hh, stash=True)
    from mucon_tpu_torch import cuda

    return cuda.bilstm_train_forward(xp, m, w_hh)


def _train_backward(xp, m, w_hh, outs, cs, douts, dh, dc):
    if xp.device.type == "cpu":
        coefs = bilstm_bwd_coefs_plain(xp, m, w_hh, outs, cs)
        return bilstm_bwd_chain_plain(coefs, m, w_hh, douts, dh, dc)
    from mucon_tpu_torch import cuda

    return cuda.bilstm_train_backward(xp, m, w_hh, outs, cs, douts, dh, dc)


class BiLSTMRecurrenceTrain(torch.autograd.Function):
    """The recurrence with its own backward (lstm_pallas.py:265-287): the
    CUDA kernels on CUDA tensors, their plain twins on CPU tensors."""

    @staticmethod
    def forward(ctx, xp, m, w_hh):
        xp, m, w_hh = xp.contiguous(), m.contiguous(), w_hh.contiguous()
        outs, h, c, cs = _train_forward(xp, m, w_hh)
        ctx.save_for_backward(xp, m, w_hh, outs, cs)
        return outs, h, c

    @staticmethod
    def backward(ctx, douts, dh, dc):
        xp, m, w_hh, outs, cs = ctx.saved_tensors
        state = outs.new_zeros(outs.shape[1:])  # h_fin's and c_fin's shape, also at T = 0
        douts, dh, dc = (torch.zeros_like(ref) if g is None else g.contiguous()
                         for g, ref in ((douts, outs), (dh, state), (dc, state)))
        dxp = _train_backward(xp, m, w_hh, outs, cs, douts, dh, dc)
        # the gates of step t consumed h_prev = outs[t - 1] (zeros at t = 0)
        h_prev = torch.cat([torch.zeros_like(outs[:1]), outs[:-1]])
        dw = torch.einsum("tdbh,tdbg->dhg", h_prev, dxp)
        return dxp, None, dw


def bilstm_recurrence_train(xp, m, w_hh):
    """Differentiable recurrence: autograd of the plain twin on CPU tensors,
    the CUDA kernels (forward with cell stash, coefficient pass and cluster
    chain) on CUDA tensors."""
    if xp.device.type == "cpu":
        return bilstm_recurrence_plain(xp, m, w_hh)
    return BiLSTMRecurrenceTrain.apply(xp, m, w_hh)
