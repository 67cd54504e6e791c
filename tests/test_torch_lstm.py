"""PyTorch port: the BiLSTM recurrence against the Pallas kernel (interpret
mode) and the masked BiLSTM module against the flax module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.models.lstm import MaskedBiLSTM as JaxMaskedBiLSTM
from mucon_tpu.ops.lstm_pallas import bilstm_recurrence_pallas, bilstm_recurrence_xla
from mucon_tpu_torch.convert import params_to_state_dict
from mucon_tpu_torch.models.lstm import MaskedBiLSTM
from mucon_tpu_torch.ops.lstm_recurrence import (
    bilstm_recurrence,
    bilstm_recurrence_plain,
)

torch.set_num_threads(1)

B, TZ, I, H = 3, 12, 6, 8
LENGTHS = np.array([12, 7, 1], np.int32)
TOL = dict(rtol=1e-5, atol=1e-5)


def _recurrence_inputs():
    rng = np.random.RandomState(1)
    xp = rng.randn(TZ, 2, B, 4 * H).astype(np.float32)
    m = (np.arange(TZ)[:, None] < LENGTHS[None, :]).astype(np.float32)
    w_hh = (rng.randn(2, H, 4 * H) / np.sqrt(H)).astype(np.float32)
    return xp, m, w_hh


@pytest.mark.interpret
def test_plain_recurrence_matches_pallas_kernel():
    xp, m, w_hh = _recurrence_inputs()
    ref_k = bilstm_recurrence_pallas(jnp.asarray(xp), jnp.asarray(m),
                                     jnp.asarray(w_hh), interpret=True)
    ref_x = bilstm_recurrence_xla(jnp.asarray(xp), jnp.asarray(m), jnp.asarray(w_hh))
    args = tuple(torch.from_numpy(a) for a in (xp, m, w_hh))
    plain = bilstm_recurrence_plain(*args)
    disp = bilstm_recurrence(*args)  # CPU tensors -> plain twin
    for got, want_k, want_x, same in zip(plain, ref_k, ref_x, disp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want_k), **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_x), **TOL)
        assert torch.equal(got, same)
    # frozen state past each length: the final h equals the last valid step
    outs, h, _ = plain
    for b, n in enumerate(LENGTHS):
        np.testing.assert_array_equal(h[0, b].numpy(), outs[n - 1, 0, b].numpy())


@pytest.mark.parametrize("use_kernels", [True, False])
def test_masked_bilstm_matches_flax(use_kernels):
    rng = np.random.RandomState(2)
    xs = rng.randn(B, TZ, I).astype(np.float32)
    jm = JaxMaskedBiLSTM(input_size=I, hidden_size=H, use_pallas=False)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(xs), jnp.asarray(LENGTHS))["params"]
    out_ref, (h_ref, c_ref) = jm.apply({"params": params}, jnp.asarray(xs),
                                       jnp.asarray(LENGTHS))
    tm = MaskedBiLSTM(I, H)
    tm.load_state_dict(params_to_state_dict(params), strict=True)
    with torch.no_grad():
        out, (h, c) = tm(torch.from_numpy(xs), torch.as_tensor(LENGTHS).long(),
                         use_kernels=use_kernels)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), **TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), **TOL)
