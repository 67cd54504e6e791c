"""PyTorch port: the decoder chain's persistent kernels (csrc/decoder_persistent.cu)
on the CPU, where they cannot run: what each of their CTAs takes, and the
item mapping of their replay pass.

* `cuda.decoder_chain_persistent_split` (the mirror of the kernels' dealing,
  phase by phase; on the card `test_decoder_chain_persistent_plan_deals_as_split`
  holds the launch's reported chunks to it) at every H from 1 to 2048 on an
  H100's 132 CTAs and on 17: the units of the CTAs partition H, each unit's
  four gate columns 4 j + q, its cpre and q columns go with it, and the
  reverse chain's [Wih; Whh] rows j and H + j with it too; at Tz up to 2048
  the scores' frame blocks cover every (item, frame) once, the softmax
  partials' (item, rank, channel chunk) units every (item, rank, channel)
  once, rank r the cluster forward's frames [r Tz / CL, (r + 1) Tz / CL),
  the ctx chunks every (item, channel) once, and in the reverse chain K's
  tiles, the da ranges and the dsc writers each element once.
* The replay pass as the persistent kernel runs it, one step of S B items
  (item s B + b from h_in[s], c_in[s], e[s] and video b's tables), against
  `decoder_chain_replay_plain` and the JAX kernel's forward chain.

Tolerances: the item-batched step against the per-step replay 1e-6 (the same
f32 arithmetic on other batch shapes), against the JAX chain rtol 1e-5 /
atol 2e-5 (two frameworks summing in different orders, as
tests/test_torch_widths.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.ops.decoder_pallas import decoder_chain
from mucon_tpu_torch import cuda
from mucon_tpu_torch.ops.decoder_chain import decoder_chain_plain, decoder_chain_replay_plain

torch.set_num_threads(1)

# an H100 SXM's SMs (one CTA each) and a small card
CTAS = (132, 17)
TZS = (1, 5, 13, 160, 1536, 2048)


def _units_partition(split, H):
    units = [j for cta in split for j in cta["units"]]
    assert units == list(range(H)), H


@pytest.mark.parametrize("ctas", CTAS)
def test_persistent_split_partitions_units_and_columns(ctas):
    """Every H from 1 to 2048: the CTAs' units partition H (ceil or floor of
    H / ctas each, none where H < ctas); a unit's gate columns 4 j + q, its
    cpre and q columns are its owner's; the reverse chain's rows j and
    H + j of [Wih; Whh] too, so the rows partition 2H."""
    for H in range(1, cuda.MAX_H_WIDE + 1):
        fwd = cuda.decoder_chain_persistent_split(1, H, 2 * H, 1, ctas)
        bwd = cuda.decoder_chain_persistent_split(1, H, 2 * H, 1, ctas, reverse=True)
        assert len(fwd) == len(bwd) == ctas
        _units_partition(fwd, H)
        _units_partition(bwd, H)
        assert {len(c["units"]) for c in fwd} <= {H // ctas, -(-H // ctas)}, H
        gates = [g for c in fwd for g in c["gates"]]
        assert gates == list(range(4 * H)), H
        for c in fwd:
            assert all(g // 4 in c["units"] for g in c["gates"]), H
            assert c["cpre"] == c["units"] == c["q"], H
        rows = sorted(n for c in bwd for n in c["rows"])
        assert rows == list(range(2 * H)), H
        for c in bwd:
            assert all(n % H in c["units"] for n in c["rows"]), H


@pytest.mark.parametrize("ctas", CTAS)
@pytest.mark.parametrize("H", [1, 16, 33, 64, 128, 600, 768, 1181, 2048])
def test_persistent_split_partitions_frames_and_channels(ctas, H):
    """At Tz up to 2048 and 1, 3 or 31 x 8 items (the replay pass's S B),
    each phase's work as the kernel deals it, round-robin over the CTAs:
    the scores' blocks of 32 frames cover every (item, frame) once; the
    softmax partials' units cover every (item, rank, channel) once, rank r
    the cluster forward's frames of its CL ranks (`decoder_chain_fwd_plan`),
    in chunks of 128 channels where they are at most two a CTA, else 512;
    the ctx chunks every (item, channel) once; the reverse chain's K tiles
    every (frame row, unit) of [B Tz x H] once, its da ranges every (video,
    frame) once in order, and each video's dsc one writer."""
    cl = cuda.decoder_chain_fwd_plan(H)[0]
    E = 2 * H
    for Tz in TZS:
        for NI in (1, 3, 31 * 8):
            split = cuda.decoder_chain_persistent_split(NI, H, E, Tz, ctas)
            chunks = cuda.decoder_chain_persistent_chunks(NI, H, E, ctas)
            pch = chunks["pair_channels"]
            assert pch == (128 if NI * cl * -(-E // 128) <= 2 * ctas else 512)
            assert chunks["frames_block"] == 32 and chunks["ctx_channels"] == 512
            seen = np.zeros((NI, Tz), np.int32)
            for r, c in enumerate(split):
                for n, (i, frames) in enumerate(c["scores"]):
                    assert len(frames) <= 32 and frames.start % 32 == 0
                    assert i * -(-Tz // 32) + frames.start // 32 == r + n * ctas
                    seen[i, frames.start:frames.stop] += 1
            assert (seen == 1).all(), (H, Tz, NI)
            chans = np.zeros((NI, cl, E), np.int32)
            for c in split:
                for i, rank, frames, es in c["pairs"]:
                    assert frames == range(rank * Tz // cl, (rank + 1) * Tz // cl)
                    assert len(es) <= pch and es.start % pch == 0
                    chans[i, rank, es.start:es.stop] += 1
            assert (chans == 1).all(), (H, Tz, NI)
            bounds = [rank * Tz // cl for rank in range(cl + 1)]
            assert bounds[0] == 0 and bounds[-1] == Tz and bounds == sorted(bounds)
            ctx = np.zeros((NI, E), np.int32)
            for c in split:
                for i, es in c["ctx"]:
                    ctx[i, es.start:es.stop] += 1
            assert (ctx == 1).all(), (H, Tz, NI)
            if NI > 8:
                continue
            rev = cuda.decoder_chain_persistent_split(NI, H, E, Tz, ctas, reverse=True)
            da = [k for c in rev for k in c["da"]]
            assert da == list(range(NI * Tz)), (H, Tz, NI)
            assert sorted(b for c in rev for b in c["dsc"]) == list(range(NI))
            k = np.zeros((NI * Tz, H), np.int8)
            for c in rev:
                for rows, cols in c["k"]:
                    k[rows.start:rows.stop, cols.start:cols.stop] += 1
            assert (k == 1).all(), (H, Tz, NI)


def _inputs(S, B, H, E, Tz, seed):
    rng = np.random.default_rng(seed)
    tz = rng.integers(1, Tz + 1, B)
    maskf = (np.arange(Tz)[None, :] < tz[:, None]).astype(np.float32)
    r = lambda *shape: (0.4 * rng.standard_normal(shape)).astype(np.float32)  # noqa: E731
    w = lambda k, *shape: (rng.standard_normal(shape) / k ** 0.5).astype(np.float32)  # noqa: E731
    return [np.maximum(r(S, B, H), 0), r(B, Tz, E) * maskf[:, :, None], r(B, Tz, H), maskf,
            r(B, H), r(B, H), w(H, H, H), r(H), r(H), w(H + E, H, H), w(H + E, E, H), r(H),
            w(2 * H, H, 4 * H), w(2 * H, H, 4 * H), r(4 * H)]


@pytest.mark.interpret
@pytest.mark.parametrize("S,B,H,Tz", [(4, 3, 24, 9), (3, 2, 33, 17)])
def test_replay_as_one_step_of_items(S, B, H, Tz):
    """The replay pass as the persistent kernel runs it: one forward step of
    S B items, item s B + b from (h_in[s, b], c_in[s, b], e[s, b]) and video
    b's enc, pre and maskf, gives the replay's cell, relu(cpre) and h; its
    trajectory from the JAX chain's states (h_in, c_in) is the JAX chain's
    own (hs, cs, comb)."""
    E = 2 * H
    args = _inputs(S, B, H, E, Tz, S * 100 + H)
    hs, cs, comb = (np.asarray(o) for o in decoder_chain(True, *map(jnp.asarray, args)))
    h_in = np.concatenate([args[4][None], hs[:-1]])
    c_in = np.concatenate([args[5][None], cs[:-1]])
    t = [torch.from_numpy(a) for a in args]
    items = (t[0].reshape(1, S * B, H), t[1].repeat(S, 1, 1), t[2].repeat(S, 1, 1),
             t[3].repeat(S, 1), torch.from_numpy(h_in).reshape(S * B, H),
             torch.from_numpy(c_in).reshape(S * B, H), *t[6:])
    with torch.no_grad():
        h1, c1, comb1 = (o.reshape(S, B, H) for o in decoder_chain_plain(*items))
        acts, cpre, _, _ = decoder_chain_replay_plain(
            *t[:4], torch.from_numpy(h_in), torch.from_numpy(c_in), *t[6:])
    np.testing.assert_allclose(comb1, torch.relu(cpre), rtol=0, atol=1e-6)
    np.testing.assert_allclose(torch.tanh(c1), acts[4], rtol=0, atol=1e-6)
    np.testing.assert_allclose(h1, acts[3] * acts[4], rtol=0, atol=1e-6)
    for name, got, ref in (("hs", h1, hs), ("cs", c1, cs), ("comb", comb1, comb)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=2e-5, err_msg=name)
