"""PyTorch port: the trainable BiLSTM recurrence against the JAX package's
custom-VJP kernel `bilstm_recurrence_train` (interpret mode): outs, final
h and c, the cell stash, and the gradients dxp and dw_hh for one set of
cotangents.  On CPU tensors the port's dispatch takes the plain twin under
autograd, which is what `chip_smoke.py` holds the CUDA kernels against."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.ops.lstm_pallas import _bilstm_train_call, bilstm_recurrence_train as jax_train
from mucon_tpu_torch.models.lstm import MaskedBiLSTM
from mucon_tpu_torch.ops.lstm_recurrence import (
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
