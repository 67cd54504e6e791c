"""PyTorch port: the trainable BiLSTM recurrence against the JAX package's
custom-VJP kernel `bilstm_recurrence_train` (interpret mode): outs, final
h and c, the cell stash, and the gradients dxp and dw_hh for one set of
cotangents.  On CPU tensors the port's dispatch takes the plain twin under
autograd, which is what `chip_smoke.py` holds the CUDA kernels against;
`BiLSTMRecurrenceTrain` on CPU tensors runs the plain twins of its
backward's two kernels (the coefficient pass, then the regrouped chain),
held here against `jax.grad` through the JAX kernel and against autograd."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.ops.lstm_pallas import _bilstm_train_call, bilstm_recurrence_train as jax_train
from mucon_tpu_torch.models.lstm import MaskedBiLSTM
from mucon_tpu_torch.cuda import (
    BILSTM_NARROW_H, PERSISTENT, bilstm_chain_plan, bilstm_fwd_plan,
)
from mucon_tpu_torch.ops.lstm_recurrence import (
    BiLSTMRecurrenceTrain,
    bilstm_bwd_chain_plain,
    bilstm_bwd_coefs_plain,
    bilstm_recurrence_plain,
    bilstm_recurrence_train,
)

torch.set_num_threads(1)
pytestmark = pytest.mark.interpret

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(T, B, H, valid, seed=0):
    rng = np.random.RandomState(seed)
    xp = rng.randn(T, 2, B, 4 * H).astype(np.float32)
    w_hh = (rng.randn(2, H, 4 * H) / np.sqrt(H)).astype(np.float32)
    m = (np.arange(T)[:, None] < np.asarray(valid)[None, :]).astype(np.float32)
    cts = (rng.randn(T, 2, B, H).astype(np.float32), rng.randn(2, B, H).astype(np.float32),
           rng.randn(2, B, H).astype(np.float32))
    return xp, m, w_hh, cts


# a fully masked video (0 valid steps) and one that runs every step
@pytest.mark.parametrize("T,B,H,valid", [(9, 3, 8, (9, 4, 0)), (1, 1, 8, (1,))])
def test_train_recurrence_matches_jax_kernel(T, B, H, valid):
    xp, m, w_hh, cts = _inputs(T, B, H, valid)
    ref, vjp = jax.vjp(lambda a, w: jax_train(True, a, jnp.asarray(m), w),
                       jnp.asarray(xp), jnp.asarray(w_hh))
    dxp_ref, dw_ref = vjp(tuple(jnp.asarray(c) for c in cts))

    xp_t = torch.from_numpy(xp).requires_grad_()
    w_t = torch.from_numpy(w_hh).requires_grad_()
    out = bilstm_recurrence_train(xp_t, torch.from_numpy(m), w_t)
    torch.autograd.backward(out, [torch.from_numpy(c) for c in cts])
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(xp_t.grad.numpy(), np.asarray(dxp_ref), **TOL)
    np.testing.assert_allclose(w_t.grad.numpy(), np.asarray(dw_ref), **TOL)


def test_cell_stash_matches_jax_kernel():
    xp, m, w_hh, _ = _inputs(7, 2, 8, (7, 3), seed=1)
    *ref, cs_ref = _bilstm_train_call(True, jnp.asarray(xp), jnp.asarray(m),
                                      jnp.asarray(w_hh))
    with torch.no_grad():
        *got, cs = bilstm_recurrence_plain(torch.from_numpy(xp), torch.from_numpy(m),
                                           torch.from_numpy(w_hh), stash=True)
    np.testing.assert_allclose(cs.numpy(), np.asarray(cs_ref), **TOL)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_masked_bilstm_train_routes_and_backpropagates():
    """`MaskedBiLSTM(..., train=True)` computes the eval forward's values
    and carries gradients to its input and every weight."""
    g = torch.Generator().manual_seed(0)
    lstm = MaskedBiLSTM(6, 8)
    for mod in lstm.modules():
        if hasattr(mod, "reset_parameters") and mod is not lstm:
            mod.reset_parameters(g)
    xs = torch.randn(3, 10, 6, generator=g).requires_grad_()
    lengths = torch.tensor([10, 7, 2])
    with torch.no_grad():
        ref, (hr, cr) = lstm(xs, lengths, use_kernels=True)
    out, (h, c) = lstm(xs, lengths, use_kernels=True, train=True)
    torch.testing.assert_close(out, ref)
    torch.testing.assert_close(h, hr)
    (out.sum() + h.sum() + c.sum()).backward()
    assert xs.grad.abs().sum() > 0 and torch.all(xs.grad[2, 2:] == 0)
    for name, p in lstm.named_parameters():
        assert p.grad is not None and p.grad.abs().sum() > 0, name


def _torch_grads(fn, xp, m, w_hh, cts):
    a, w = torch.from_numpy(xp).requires_grad_(), torch.from_numpy(w_hh).requires_grad_()
    out = fn(a, torch.from_numpy(m), w)
    torch.autograd.backward(out[:3], [torch.from_numpy(c) for c in cts])
    return out, a.grad.numpy(), w.grad.numpy()


# ragged masks with an all-padding video; T = 1; B not a multiple of the
# chain kernel's 8-video tile
@pytest.mark.parametrize("T,B,H,valid", [
    (1, 1, 8, (1,)),
    (13, 11, 16, (13, 1, 7, 0, 12, 5, 13, 2, 9, 4, 0)),
    (6, 3, 8, (6, 2, 0)),
])
def test_function_twins_match_jax_kernel_and_autograd(T, B, H, valid):
    """`BiLSTMRecurrenceTrain` on CPU tensors (plain forward with stash, the
    coefficient pass, the regrouped chain, the einsum) against `jax.grad`
    through the JAX kernel (rtol 1e-5, atol 1e-6: f32, another grouping of
    the same products) and against autograd of the plain recurrence."""
    xp, m, w_hh, cts = _inputs(T, B, H, valid, seed=2)
    ref, vjp = jax.vjp(lambda a, w: jax_train(True, a, jnp.asarray(m), w),
                       jnp.asarray(xp), jnp.asarray(w_hh))
    dxp_ref, dw_ref = vjp(tuple(jnp.asarray(c) for c in cts))
    out, dxp, dw = _torch_grads(BiLSTMRecurrenceTrain.apply, xp, m, w_hh, cts)
    tol = dict(rtol=1e-5, atol=1e-6)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)
    np.testing.assert_allclose(dxp, np.asarray(dxp_ref), **tol)
    np.testing.assert_allclose(dw, np.asarray(dw_ref), **tol)
    _, dxp_auto, dw_auto = _torch_grads(bilstm_recurrence_plain, xp, m, w_hh, cts)
    np.testing.assert_allclose(dxp, dxp_auto, **tol)
    np.testing.assert_allclose(dw, dw_auto, **tol)
    assert not dxp[:, :, [i for i, v in enumerate(valid) if v == 0]].any()


def test_function_takes_an_empty_sequence():
    """T = 0: the Function returns empty outs and zero final states, and its
    backward (the two kernels' twins on CPU tensors) an empty dxp and a zero
    w_hh gradient, as autograd of the recurrence has none."""
    B, H = 2, 8
    xp = torch.zeros(0, 2, B, 4 * H, requires_grad=True)
    w_hh = torch.randn(2, H, 4 * H, generator=torch.Generator().manual_seed(0)).requires_grad_()
    outs, h, c = BiLSTMRecurrenceTrain.apply(xp, torch.zeros(0, B), w_hh)
    assert outs.shape == (0, 2, B, H) and not h.any() and not c.any()
    torch.autograd.backward((outs, h, c), (torch.zeros_like(outs), torch.ones(2, B, H),
                                           torch.ones(2, B, H)))
    assert xp.grad.shape == (0, 2, B, 4 * H) and not w_hh.grad.any()


def test_padded_step_passes_state_through_exactly():
    """At m = 0 the chain emits dgate = 0 and carries (dh + douts[t], dc)
    on bit for bit: after padded steps with zero douts the state that
    reaches the valid steps is the final cotangent itself."""
    T, B, H, valid = 7, 2, 8, (3, 7)
    xp, m, w_hh, cts = _inputs(T, B, H, valid, seed=3)
    xp, m, w_hh = torch.from_numpy(xp), torch.from_numpy(m), torch.from_numpy(w_hh)
    douts, dh, dc = (torch.from_numpy(c) for c in cts)
    douts = douts * m[:, None, :, None]  # no cotangent at padded steps
    with torch.no_grad():
        outs, _, _, cs = bilstm_recurrence_plain(xp, m, w_hh, stash=True)
        coefs = bilstm_bwd_coefs_plain(xp, m, w_hh, outs, cs)
        dxp = bilstm_bwd_chain_plain(coefs, m, w_hh, douts, dh, dc)
        # video 0 is padding from t = 3 on: cut there, the chain starts from (dh, dc)
        cut = bilstm_bwd_chain_plain(coefs[:, :3], m[:3], w_hh, douts[:3], dh, dc)
    assert not dxp[3:, :, 0].any()
    assert torch.equal(dxp[:3, :, 0], cut[:, :, 0])
    a, co = coefs[0], coefs[4]
    assert not a[3:, :, 0].any() and not co[3:, :, 0].any()  # the mask is folded in


@pytest.mark.parametrize("H,want", [(8, 1), (16, 1), (32, 2), (64, 4), (128, 8), (256, 8)])
def test_chain_plan_covers_every_gate_row(H, want):
    """Up to H = 256 the reverse chain stays on its cluster kernels (above,
    the persistent kernel): the width follows from H, every CTA's columns
    have a thread per video, and the thread groups' gate-row ranges
    (multiples of 4, at most 128 rows) cover all 4H rows once, in an order
    that depends on H alone (the same plan at every call)."""
    cl, hs, nq, gpq = bilstm_chain_plan(H)
    assert cl == want != PERSISTENT and H <= BILSTM_NARROW_H
    assert cl * hs == H and 8 * hs <= 256 and nq * hs <= 256
    assert gpq % 4 == 0 and gpq <= 128 and nq * gpq >= 4 * H
    rows = [g for q in range(nq) for g in range(q * gpq, min(4 * H, (q + 1) * gpq))]
    assert rows == list(range(4 * H))
    assert bilstm_chain_plan(H) == (cl, hs, nq, gpq)
    with pytest.raises(ValueError):
        bilstm_chain_plan(2049)


@pytest.mark.parametrize("H,want", [(8, (1, 256)), (16, (1, 256)), (32, (2, 256)),
                                    (64, (4, 256)), (128, (8, 256)), (256, (8, 512))])
def test_fwd_plan_covers_every_gate_row_and_unit(H, want):
    """Up to H = 256 the forward stays on its cluster kernels, w_hh in
    registers (KC <= 64): over the CL CTAs, the threads' (k-row, gate
    column) pairs cover w_hh [H x 4H] once each, every CTA owns all four
    gates of its units, each (video, unit) of an 8-video tile has a thread,
    and the k-groups (the order the coefficient pass replays) depend on H
    alone."""
    cl, hs, nt, nk, kc = bilstm_fwd_plan(H)
    assert (cl, nt) == want and cl != PERSISTENT and cl * hs == H
    assert kc % 4 == 0 and kc <= 64 and 8 * hs <= nt and nk * 4 * hs <= nt
    cols = 4 * hs
    covered = []
    for r in range(cl):
        units = set()
        for tid in range(nk * cols):
            pc, kq = tid % cols, tid // cols
            gcol = (pc // hs) * H + r * hs + pc % hs
            units.add(gcol % H)
            covered += [(k, gcol) for k in range(kq * kc, min(H, (kq + 1) * kc))]
        assert units == set(range(r * hs, (r + 1) * hs))
        assert {q * H + j for q in range(4) for j in units} == {
            (pc // hs) * H + r * hs + pc % hs for pc in range(cols)}
    assert sorted(covered) == [(k, g) for k in range(H) for g in range(4 * H)]
    assert bilstm_fwd_plan(H) == (cl, hs, nt, nk, kc)
    for bad in (0, 2049):
        with pytest.raises(ValueError):
            bilstm_fwd_plan(bad)
