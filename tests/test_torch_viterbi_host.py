"""PyTorch port: the host Viterbi decoder and the length models
(mucon_tpu_torch/decode) against mucon_tpu's, and the port's dense DP on
full-T tables (`ops/viterbi.py viterbi_precompute`) against the port's
host decoder.

The length models are numpy on both sides and are held equal element for
element.  `ViterbiDecoder` (float64 on both sides) on a single-transcript
grammar and on path grammars of several transcripts, with and without
pruning, gives the same labels and segments and a score within 1e-9 over
several seeds.  The dense DP (f32, the CPU twins of the kernel and of the
pointer walk) on problems without near ties gives the host decoder's
labels and segments, its score within 2e-4 relative (f32 against float64,
the JAX package's bound in tests/test_viterbi.py).
"""

import numpy as np
import pytest
import torch

from mucon_tpu.decode import grammar as jax_grammar
from mucon_tpu.decode import length_model as jax_lm
from mucon_tpu.decode.viterbi_host import ViterbiDecoder as JaxDecoder
from mucon_tpu.ops.viterbi import dense_viterbi_decode_batch as jax_dense_batch
from mucon_tpu_torch.decode import grammar, length_model
from mucon_tpu_torch.decode.viterbi_host import ViterbiDecoder
from mucon_tpu_torch.ops.viterbi import (
    dense_viterbi_decode_batch,
    dense_viterbi_plain,
    viterbi_precompute,
)
from tests.test_viterbi import _random_problem

torch.set_num_threads(1)


def _segments(segs):
    return [(int(s.label), int(s.length)) for s in segs]


@pytest.mark.parametrize("lam", [[30.0, 55.5, 1.0, 120.49], [2.5, 3.5, 700.0, 61.7]])
def test_length_models_match_jax(lam):
    np.testing.assert_array_equal(length_model.poisson_log_table(lam, 300),
                                  jax_lm.poisson_log_table(lam, 300))
    np.testing.assert_array_equal(length_model.poisson_log_table(lam, 300, False),
                                  jax_lm.poisson_log_table(lam, 300, False))
    ours, ref = length_model.PoissonModel(lam, max_length=300), jax_lm.PoissonModel(lam, 300)
    assert ours.n_classes() == ref.n_classes() == 4 and ours.max_length() == 300
    mean, jmean = length_model.MeanLengthModel(4, 500, 200.0), jax_lm.MeanLengthModel(4, 500)
    multi = length_model.MultiPoissonModel([30.0, 55.0], num_classes=4)
    jmulti = jax_lm.MultiPoissonModel([30.0, 55.0], num_classes=4)
    for n in (0, 1, 29, 150, 200, 201, 299, 300, 450, 501):
        for c in range(4):
            assert ours.score(n, c) == ref.score(n, c)
            assert mean.score(n, c) == jmean.score(n, c)
            for i in (0, 1):
                assert multi.score_multi(i, n, c) == jmulti.score_multi(i, n, c)
    with pytest.raises(NotImplementedError):
        multi.score(3, 0)


def _check_host(ours, ref, log_probs):
    s1, l1, g1 = ours.decode(log_probs)
    s2, l2, g2 = ref.decode(log_probs)
    assert np.isfinite(s2)
    assert abs(s1 - s2) <= 1e-9 * max(1.0, abs(s2))
    assert list(l1) == list(l2)
    assert _segments(g1) == _segments(g2)
    return s1, l1, g1


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_host_decoder_single_transcript_matches_jax(seed):
    rng = np.random.RandomState(seed)
    T, M, N = int(rng.randint(200, 700)), 8, int(rng.randint(1, 6))
    lp, tr, lam = _random_problem(rng, T, M, N)
    S = int(rng.choice([10, 15, 30]))
    ours = ViterbiDecoder(grammar.SingleTranscriptGrammar(tr, M),
                          length_model.PoissonModel(lam), frame_sampling=S)
    ref = JaxDecoder(jax_grammar.SingleTranscriptGrammar(tr, M), jax_lm.PoissonModel(lam),
                     frame_sampling=S)
    _, labels, segs = _check_host(ours, ref, lp.astype(np.float64))
    assert len(labels) == T and sum(s.length for s in segs) == T


@pytest.mark.parametrize("seed,max_hyp", [(0, np.inf), (1, np.inf), (2, 40), (3, 7)])
def test_host_decoder_path_grammar_matches_jax(seed, max_hyp):
    """Several transcripts sharing prefixes (a branching trie), a
    mean-length model, and pruning by (score, state key)."""
    rng = np.random.RandomState(seed)
    T, M = int(rng.randint(150, 400)), 6
    base = [int(x) for x in rng.randint(0, M, size=3)]
    transcripts = [base, base[:2], base + [int(rng.randint(M))],
                   [int(x) for x in rng.randint(0, M, size=4)]]
    lp = np.log(rng.dirichlet(np.ones(M) * 0.3, size=T) + 1e-8)
    ours = ViterbiDecoder(grammar.ModifiedPathGrammar(transcripts, M),
                          length_model.MeanLengthModel(M, 300, 60.0), 10, max_hyp)
    ref = JaxDecoder(jax_grammar.ModifiedPathGrammar(transcripts, M),
                     jax_lm.MeanLengthModel(M, 300, 60.0), 10, max_hyp)
    _check_host(ours, ref, lp)


def test_host_decoder_remainder_and_degenerate_input():
    """The remainder frames lead with the last label; a video too short for
    any hypothesis decodes to background, as in the reference."""
    T, M = 95, 5
    lp = np.full((T, M), -5.0)
    lp[:30, 0] = lp[30:, 1] = -0.1
    lam = np.array([30.0, 60.0, 1, 1, 1])
    ours = ViterbiDecoder(grammar.SingleTranscriptGrammar([0, 1], M),
                          length_model.PoissonModel(lam), frame_sampling=30)
    ref = JaxDecoder(jax_grammar.SingleTranscriptGrammar([0, 1], M), jax_lm.PoissonModel(lam),
                     frame_sampling=30)
    _, labels, _ = _check_host(ours, ref, lp)
    assert list(labels[:5]) == [1] * 5
    short = ViterbiDecoder(grammar.SingleTranscriptGrammar([0, 1], M),
                           length_model.PoissonModel(lam, max_length=20), frame_sampling=30)
    score, labels, segs = short.decode(lp)
    assert score == -np.inf and labels == [0] * T and _segments(segs) == [(0, T)]


def _batch(seed, B=4, M=9, n_max=6, t_pad=960, S=30):
    rng = np.random.RandomState(seed)
    lps, t_valid, trs, n_valid, lams = [], [], [], [], []
    for _ in range(B):
        N = int(rng.randint(1, n_max + 1))
        T = int(rng.randint(2 * S * N + 5, t_pad - 10))  # a feasible video
        lp, tr, lam = _random_problem(rng, T, M, N)
        lps.append(np.pad(lp, ((0, t_pad - T), (0, 0))))
        t_valid.append(T)
        trs.append(tr + [0] * (n_max - N))
        n_valid.append(N)
        lams.append(lam)
    return (np.stack(lps), np.array(t_valid), np.array(trs), np.array(n_valid),
            np.stack(lams).astype(np.float32))


# seeds whose problems have no near tie between the best two paths
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_decode_on_full_tables_matches_host_decoder(seed):
    lps, t_valid, trs, n_valid, lams = _batch(seed)
    runs = [dense_viterbi_decode_batch(lps, t_valid, trs, n_valid, lams, frame_sampling=30,
                                       device="cpu", use_kernels=k) for k in (True, False)]
    for b in range(len(t_valid)):
        T, N = int(t_valid[b]), int(n_valid[b])
        host = ViterbiDecoder(grammar.SingleTranscriptGrammar(list(trs[b, :N]), lams.shape[1]),
                              length_model.PoissonModel(lams[b].astype(np.float64)),
                              frame_sampling=30)
        score, labels, segs = host.decode(lps[b, :T].astype(np.float64))
        for res in runs:
            np.testing.assert_allclose(res[b].score, score, rtol=2e-4, atol=2e-3)
            assert list(res[b].labels) == list(labels)
            assert _segments(res[b].segments) == _segments(segs)


# tie-free seeds: in seeds 4 and 5 a transcript repeats a label, whose
# split point the f32 scores of the two packages place apart at a near tie
@pytest.mark.parametrize("seed", [3, 6, 7])
def test_full_tables_and_dense_decode_match_jax(seed):
    """`viterbi_precompute` and the DP on its tables against the JAX
    package's batched dense decode (its XLA scan and host walk)."""
    lps, t_valid, trs, n_valid, lams = _batch(seed, B=5)
    ours = dense_viterbi_decode_batch(lps, t_valid, trs, n_valid, lams, frame_sampling=30,
                                      device="cpu")
    ref = jax_dense_batch(lps, t_valid, trs, n_valid, lams, frame_sampling=30)
    for a, b in zip(ours, ref):
        assert a.score == pytest.approx(b.score, rel=1e-6, abs=1e-4)
        np.testing.assert_array_equal(a.labels, b.labels)
        assert _segments(a.segments) == _segments(b.segments)
    W, pois, k_valid = viterbi_precompute(
        torch.as_tensor(lps), torch.as_tensor(t_valid), torch.as_tensor(trs),
        torch.as_tensor(lams), frame_sampling=30, max_len=2000, l_max=66)
    assert W.shape == (5, 32, 6) and pois.shape == (5, 6, 66)  # K = 960 // 30
    assert torch.equal(k_valid, torch.as_tensor(t_valid) // 30)
    score, _, _ = dense_viterbi_plain(W, pois, k_valid, torch.as_tensor(n_valid), 30)
    np.testing.assert_allclose(score.numpy(), [r.score for r in ref], rtol=1e-6, atol=1e-4)


def test_dense_decode_defaults_to_the_card():
    """With no device named, the batched decode asks for the card, and
    raises where there is none rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    lps, t_valid, trs, n_valid, lams = _batch(0, B=2)
    with pytest.raises(RuntimeError, match="cuda"):
        dense_viterbi_decode_batch(lps, t_valid, trs, n_valid, lams, frame_sampling=30)
