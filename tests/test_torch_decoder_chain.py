"""PyTorch port: the teacher-forced decoder chain (`ops/decoder_chain.py`)
against the JAX package's (`mucon_tpu/ops/decoder_pallas.py`, its Pallas
kernels in interpret mode) on the CPU: the plain forward, every input
gradient of `DecoderChain` (its backward rule and weight-gradient glue,
with the plain reverse chain inside), and the whole teacher-forced decode
with the heads on the weights of an initialised model.  Also the forward
kernel's cluster arithmetic (`decoder_chain_cluster_plain`: the attention
summed by ranks of frames) against both, and its split of H over a cluster
(`cuda.decoder_chain_fwd_plan`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.models import create_model as create_jax_model
from mucon_tpu.ops.decoder_pallas import decoder_chain, decoder_chain_xla
from mucon_tpu.ops.decoder_pallas import decoder_teacher_forced as jax_teacher_forced
from mucon_tpu_torch import cuda
from mucon_tpu_torch.cuda import decoder_chain_fwd_plan
from mucon_tpu_torch.models.model import create_model, model_fields_from_cfg
from mucon_tpu_torch.ops.decoder_chain import (
    DecoderChain,
    _attention,
    _attention_by_ranks,
    _step,
    decoder_chain_bwd_plain,
    decoder_chain_cluster_plain,
    decoder_chain_plain,
    decoder_chain_replay_plain,
    decoder_teacher_forced,
)
from tests.test_model import D, M, NMAX, small_cfg

torch.set_num_threads(1)

S, B, Tz, H, E = 6, 3, 10, 8, 16
TZ_VALID = (Tz, 7, 3)  # one fully valid video and two masked ones
NAMES = ("emb", "enc", "pre", "maskf", "h0", "c0", "wl2", "bl2", "v", "wc1", "wc2", "bc",
         "wih", "whh", "bl")


def _inputs(seed, h=H, e=E, s=S, tz=Tz, valid=TZ_VALID):
    rng = np.random.RandomState(seed)
    r = lambda *sh: (rng.randn(*sh) * 0.4).astype(np.float32)  # noqa: E731
    b = len(valid)
    maskf = (np.arange(tz)[None, :] < np.array(valid)[:, None]).astype(np.float32)
    return [np.maximum(r(s, b, h), 0.0), r(b, tz, e) * maskf[:, :, None], r(b, tz, h), maskf,
            r(b, h), r(b, h), r(h, h), r(h), r(h), r(h, h), r(e, h), r(h), r(h, 4 * h),
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


def _reverse_loop(emb, enc, pre, maskf, h_in, c_in, wl2, bl2, v, wc1, wc2, bc, wih, whh, bl,
                  dhs, dcs, dcomb_ext):
    """The reverse chain as one loop that replays each step inside it (the
    form of the JAX kernel, decoder_pallas.py:160-210)."""
    dh_c, dc_c = torch.zeros_like(h_in[0]), torch.zeros_like(c_in[0])
    out = [[None] * len(emb) for _ in range(3)]
    for s in reversed(range(len(emb))):
        c = c_in[s]
        _, c_out, _, cpre, (i, f, g, o), (_, u, a, _) = _step(
            emb[s], h_in[s], c, enc, pre, maskf, wl2, bl2, v, wc1, wc2, bc, wih, whh, bl)
        tc = torch.tanh(c_out)
        dh, dc = dh_c + dhs[s], dc_c + dcs[s]
        dct = dh * o * (1.0 - tc * tc) + dc
        dc_c = dct * f
        dg = torch.cat([dct * g * i * (1.0 - i), dct * c * f * (1.0 - f),
                        dct * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], dim=-1)
        dcp = (dg @ wih.t() + dcomb_ext[s]) * (cpre > 0.0).to(dg.dtype)
        da = torch.bmm(enc, (dcp @ wc2.t())[:, :, None])[:, :, 0]
        ds = a * (da - torch.sum(a * da, dim=-1, keepdim=True))
        dq = torch.sum(ds[:, :, None] * v * (1.0 - u * u), dim=1)
        dh_c = dg @ whh.t() + dq @ wl2.t()
        out[0][s], out[1][s], out[2][s] = dg, dcp, ds
    return (*(torch.stack(x) for x in out), dh_c, dc_c)


def _reverse_args(args, seed):
    """(inputs of the reverse chain, with the forward's trajectory as h_in /
    c_in) and the forward's comb."""
    t = list(map(torch.from_numpy, args))
    hs, cs, comb = decoder_chain_plain(*t)
    h_in, c_in = torch.cat([t[4][None], hs[:-1]]), torch.cat([t[5][None], cs[:-1]])
    rng = np.random.RandomState(seed)
    cts = [torch.from_numpy(rng.randn(*hs.shape).astype(np.float32)) for _ in range(3)]
    return (*t[:4], h_in, c_in, *t[6:], *cts), comb


def test_split_twins_compose_to_the_reverse_loop():
    """The replay twin and the chain twin compose to the one-loop reverse
    chain bit for bit, and the replayed relu(cpre) is the forward's comb bit
    for bit (the statement the card holds the replay kernel to)."""
    bargs, comb = _reverse_args(_inputs(4), seed=5)
    with torch.no_grad():
        got = decoder_chain_bwd_plain(*bargs)
        want = _reverse_loop(*bargs)
        _, cpre, a, u = decoder_chain_replay_plain(*bargs[:15])
    for name, x, y in zip(("dgate", "dcpre", "dsc", "dh0", "dc0"), got, want):
        assert torch.equal(x, y), name
    assert torch.equal(torch.relu(cpre), comb)
    assert a.shape == (S, B, Tz) and u.shape == (S, B, Tz, H)
    assert not a[:, 2, TZ_VALID[2]:].any()  # masked frames weigh exactly 0


# a masked tail (two of three videos padded); Tz = 1 (one frame a video)
@pytest.mark.parametrize("s,tz,valid", [(5, 12, (12, 8, 3)), (3, 1, (1, 1))],
                         ids=["masked_tail", "Tz1"])
def test_composed_twins_match_jax_vjp(s, tz, valid):
    """dh0 and dc0 of the composed twins, and every input gradient of
    `DecoderChain` (its glue around them), against `jax.vjp` of the JAX
    kernel in interpret mode (rtol 2e-4, atol 2e-5: the JAX kernel test's
    own tolerances for two f32 orders of the same sums)."""
    args = _inputs(7, s=s, tz=tz, valid=valid)
    rng = np.random.RandomState(8)
    cts = [rng.randn(s, len(valid), H).astype(np.float32) for _ in range(3)]
    argnums = tuple(i for i in range(15) if i != 3)
    _, vjp = jax.vjp(lambda *a: decoder_chain(True, *a[:3], jnp.asarray(args[3]), *a[3:]),
                     *(jnp.asarray(args[i]) for i in argnums))
    ref = vjp(tuple(map(jnp.asarray, cts)))
    tol = dict(rtol=2e-4, atol=2e-5)
    bargs, _ = _reverse_args(args, seed=0)
    bargs = (*bargs[:15], *map(torch.from_numpy, cts))
    with torch.no_grad():
        *_, dh0, dc0 = decoder_chain_bwd_plain(*bargs)
    np.testing.assert_allclose(dh0.numpy(), np.asarray(ref[3]), **tol)  # h0 is input 4
    np.testing.assert_allclose(dc0.numpy(), np.asarray(ref[4]), **tol)
    xs = [torch.from_numpy(a).requires_grad_(i != 3) for i, a in enumerate(args)]
    outs = DecoderChain.apply(*xs)
    torch.autograd.backward(outs, list(map(torch.from_numpy, cts)))
    for i, want in zip(argnums, ref):
        np.testing.assert_allclose(xs[i].grad.numpy(), np.asarray(want), **tol,
                                   err_msg=NAMES[i])


# a ragged split (13 frames over 4 ranks: 3, 3, 3, 4); fewer frames than
# ranks (3 over 8: five ranks hold none); a fully masked rank (video 1 is
# padding from frame 5 on: ranks 2 and 3 of 4 hold no valid frame)
@pytest.mark.parametrize("tz,valid,cl", [(13, (13, 9, 2), 4), (3, (3, 1), 8),
                                         (16, (16, 5, 9), 4)],
                         ids=["ragged", "Tz_below_CL", "masked_rank"])
def test_cluster_twin_matches_plain_and_jax(tz, valid, cl):
    """The forward kernel's sums (rank partials of the softmax and the
    context, combined in rank order) against the one-pass attention and
    the JAX kernel in interpret mode: atol 1e-5, two orders of the same
    sums; masked frames weigh exactly 0 and no rank gives a NaN."""
    args = _inputs(9, tz=tz, valid=valid)
    t = list(map(torch.from_numpy, args))
    att_args = (t[4], t[2], t[1], t[3], t[6], t[7], t[8])  # h0, pre, enc, maskf, wl2, bl2, v
    q, u, a, ctx = _attention_by_ranks(*att_args, cl=cl)
    for name, x, y in zip(("q", "u", "a", "ctx"), (q, u, a, ctx), _attention(*att_args)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6, err_msg=name)
    assert torch.equal(a * t[3], a)
    np.testing.assert_allclose(a.sum(dim=-1).numpy(), 1.0, atol=1e-6)
    got = decoder_chain_cluster_plain(*t, cl=cl)
    for ref in (decoder_chain_plain(*t), decoder_chain(True, *map(jnp.asarray, args))):
        for name, x, y in zip(("hs", "cs", "comb"), got, ref):
            assert torch.isfinite(x).all()
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("H,want", [(1, 1), (8, 1), (32, 4), (33, 4), (100, 8), (128, 8),
                                    (129, 8), (256, 8)])
def test_fwd_plan_covers_every_product_once(H, want):
    """The cluster split of the forward chain (csrc/decoder_chain.cu
    `cluster_step`): over the CL CTAs of 8 warps, the (k, column) pairs of
    q (each CTA its units' rows, every column: the partials summed in rank
    order), of the combine layer (E = 2H; the e rows, then the context's;
    passes of 4 columns a warp) and of the gates (the h rows, then comb's;
    passes of 8 columns a warp, column 4 jj + q the gate q of unit jj)
    cover each matrix once, on the ragged split (`units_of`: CTA r's share
    of ceil or floor of H / CL units, HS the largest) as on the even one;
    the last two are warp GEMVs, lane l of a warp taking k = l, l + 32, ...
    The CTAs' units partition H, and their frames partition [0, Tz), also
    where Tz < CL.  Every H from 1 is taken, on 8 CTAs from H = 64."""
    cl, hs, nt = decoder_chain_fwd_plan(H)
    shares = [cuda.units_of(r, cl, H) for r in range(cl)]
    assert cl == want and max(map(len, shares)) == hs and nt == 256
    E, warps = 2 * H, nt // 32

    def gemv(col0, C, ncol, k0, k1):
        return [(k, col0 + c) for lane in range(32) for k in range(k0 + lane, k1, 32)
                for c in range(C) if col0 + c < ncol]

    q = [(j, n) for u in shares for n in range(H) for j in u]
    assert sorted(q) == [(k, n) for k in range(H) for n in range(H)]
    comb, gates, units = [], [], []
    for u in shares:
        j0, n_r = u.start, len(u)
        for w in range(warps):
            comb += [(k, j0 + jj) for col0 in range(4 * w, n_r, 4 * warps)
                     for k0, k1 in ((0, H), (H, H + E))
                     for k, jj in gemv(col0, 4, n_r, k0, k1)]
            gates += [(k, (col & 3) * H + j0 + (col >> 2)) for t in range(-(-4 * n_r // 64))
                      for k0, k1 in ((H, 2 * H), (0, H))
                      for k, col in gemv(64 * t + 8 * w, 8, 4 * n_r, k0, k1)]
        units += u
    assert sorted(comb) == [(k, n) for k in range(H + E) for n in range(H)]
    assert sorted(gates) == [(k, n) for k in range(2 * H) for n in range(4 * H)]
    assert units == list(range(H))
    for tz in (1, 3, 13, 160):
        frames = [t for r in range(cl) for t in range(r * tz // cl, (r + 1) * tz // cl)]
        assert frames == list(range(tz))
        assert max((r + 1) * tz // cl - r * tz // cl for r in range(cl)) <= -(-tz // cl)
    for bad in (0, 2049):
        with pytest.raises(ValueError):
            decoder_chain_fwd_plan(bad)
