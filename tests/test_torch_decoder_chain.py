"""PyTorch port: the teacher-forced decoder chain (`ops/decoder_chain.py`)
against the JAX package's (`mucon_tpu/ops/decoder_pallas.py`, its Pallas
kernels in interpret mode) on the CPU: the plain forward, every input
gradient of `DecoderChain` (its backward rule and weight-gradient glue,
with the plain reverse chain inside), and the whole teacher-forced decode
with the heads on the weights of an initialised model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.models import create_model as create_jax_model
from mucon_tpu.ops.decoder_pallas import decoder_chain, decoder_chain_xla
from mucon_tpu.ops.decoder_pallas import decoder_teacher_forced as jax_teacher_forced
from mucon_tpu_torch.models.model import create_model, model_fields_from_cfg
from mucon_tpu_torch.ops.decoder_chain import (
    DecoderChain,
    decoder_chain_plain,
    decoder_teacher_forced,
)
from tests.test_model import D, M, NMAX, small_cfg

torch.set_num_threads(1)

S, B, Tz, H, E = 6, 3, 10, 8, 16
TZ_VALID = (Tz, 7, 3)  # one fully valid video and two masked ones
NAMES = ("emb", "enc", "pre", "maskf", "h0", "c0", "wl2", "bl2", "v", "wc1", "wc2", "bc",
         "wih", "whh", "bl")


def _inputs(seed, h=H, e=E):
    rng = np.random.RandomState(seed)
    r = lambda *s: (rng.randn(*s) * 0.4).astype(np.float32)  # noqa: E731
    maskf = (np.arange(Tz)[None, :] < np.array(TZ_VALID)[:, None]).astype(np.float32)
    return [np.maximum(r(S, B, h), 0.0), r(B, Tz, e) * maskf[:, :, None], r(B, Tz, h), maskf,
            r(B, h), r(B, h), r(h, h), r(h), r(h), r(h, h), r(e, h), r(h), r(h, 4 * h),
            r(h, 4 * h), r(4 * h)]


def test_chain_forward_matches_jax():
    args = _inputs(0)
    got = decoder_chain_plain(*map(torch.from_numpy, args))
    jargs = list(map(jnp.asarray, args))
    # two frameworks sum in different orders: atol 1e-5
    for ref in (decoder_chain(True, *jargs), decoder_chain_xla(*jargs)):
        for name, a, b in zip(("hs", "cs", "comb"), got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=name)


def test_chain_gradients_match_jax():
    """All 14 differentiable inputs (maskf is a constant selector) through
    `DecoderChain`'s backward against `jax.grad` of the JAX kernel, at the
    JAX kernel test's own tolerances."""
    args = _inputs(1)
    rng = np.random.RandomState(9)
    cts = [rng.randn(S, B, H).astype(np.float32) for _ in range(3)]

    def loss_kernel(*a):
        outs = decoder_chain(True, *a)
        return sum(jnp.sum(o * w) for o, w in zip(outs, cts))

    argnums = tuple(i for i in range(15) if i != 3)
    ref = jax.grad(loss_kernel, argnums=argnums)(*map(jnp.asarray, args))

    xs = [torch.from_numpy(a).requires_grad_(i != 3) for i, a in enumerate(args)]
    outs = DecoderChain.apply(*xs)
    sum(torch.sum(o * torch.from_numpy(w)) for o, w in zip(outs, cts)).backward()
    assert xs[3].grad is None
    for i, want in zip(argnums, ref):
        np.testing.assert_allclose(xs[i].grad.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5,
                                   err_msg=NAMES[i])


@pytest.fixture(scope="module")
def decoder_weights():
    cfg = small_cfg()
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0)))
    tm = create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg))
    tm.load_jax_params(params)
    return params["decoder"], tm.net.decoder


@pytest.mark.parametrize("use_kernel", [True, False], ids=["DecoderChain", "plain"])
def test_teacher_forced_decode_matches_jax(decoder_weights, use_kernel):
    dp, dec = decoder_weights
    h = dec.attention_l2.kernel.shape[0]
    emb, enc, pre, maskf, h0, c0 = _inputs(3, h=h, e=2 * h)[:6]
    ref = jax_teacher_forced(dp, *map(jnp.asarray, (emb, enc, pre, maskf, h0, c0)),
                             use_kernel=True, interpret=True)
    with torch.no_grad():
        got = decoder_teacher_forced(dec, *map(torch.from_numpy, (emb, enc, pre, maskf, h0, c0)),
                                     use_kernel=use_kernel)
    assert got[0].shape == (S, B, M + 1) and got[1].shape == (S, B)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
