"""PyTorch port: the library API that no entry point reaches, each function
against its mucon_tpu counterpart on the same inputs.

* `decode.PathGrammar` and `decode.NGram` read from one transcript file
  (mucon_tpu/decode/grammar.py:65, :99), `perplexity` included;
* `metrics.MoFAccuracyFromLogitsMetric` (segmentation.py:105) on logits
  with ties, as numpy and as a torch tensor;
* `ops.dense_viterbi_decode`, the one-video decode (ops/viterbi.py:241),
  on the CPU: scores within 1e-5, labels and segments equal;
* `data.utils` `summarize_list`, `unsummarize_list` and
  `segment_to_labels` (data/utils.py:18-48), empty lists included.
"""

import numpy as np
import pytest
import torch

from mucon_tpu.data import utils as jax_utils
from mucon_tpu.decode import NGram as JaxNGram
from mucon_tpu.decode import PathGrammar as JaxPathGrammar
from mucon_tpu.metrics import MoFAccuracyFromLogitsMetric as JaxMoFFromLogits
from mucon_tpu.ops import dense_viterbi_decode as jax_dense_viterbi_decode
from mucon_tpu_torch.data import segment_to_labels, summarize_list, unsummarize_list
from mucon_tpu_torch.decode import NGram, PathGrammar
from mucon_tpu_torch.metrics import MoFAccuracyFromLogitsMetric
from mucon_tpu_torch.ops import dense_viterbi_decode

torch.set_num_threads(1)

LABELS = {"SIL": 0, "take_cup": 1, "pour_milk": 2, "stir": 3, "pour_coffee": 4}
TRANSCRIPTS = [
    "SIL take_cup pour_coffee SIL",
    "SIL take_cup pour_milk stir SIL",
    "SIL take_cup pour_coffee pour_milk stir SIL",
    "SIL pour_milk SIL",
    "SIL take_cup pour_coffee SIL",
]


@pytest.fixture
def transcript_file(tmp_path):
    path = tmp_path / "transcripts.txt"
    path.write_text("\n".join(TRANSCRIPTS) + "\n")
    return str(path)


def test_path_grammar_matches_jax(transcript_file):
    got, ref = PathGrammar(transcript_file, LABELS), JaxPathGrammar(transcript_file, LABELS)
    assert got.successors == ref.successors and got.n_classes() == ref.n_classes() == 5
    for context in [(-1,), (-1, 0), (-1, 0, 1), (-1, 0, 1, 4), (-1, 3), ()]:
        assert got.possible_successors(context) == ref.possible_successors(context)
        for label in list(range(5)) + [-2]:
            assert got.score(context, label) == ref.score(context, label)


@pytest.mark.parametrize("order", [1, 2])
def test_ngram_matches_jax(transcript_file, order):
    got = NGram(transcript_file, LABELS, order)
    ref = JaxNGram(transcript_file, LABELS, order)
    assert got.ngrams == ref.ngrams and got.vocabulary == ref.vocabulary
    assert got.lambdas == ref.lambdas and got.normalization == ref.normalization
    contexts = [(), (-1,), (0,), (-1, 0), (0, 1), (1, 4), (3, 0), (4, 2)]
    for context in contexts:
        context = context[len(context) - (order - 1):] if order > 1 else ()
        assert got.possible_successors(context) == ref.possible_successors(context)
        for label in list(range(5)) + [-2]:
            assert got.score(context, label) == ref.score(context, label), (context, label)
        assert got.update_context(context, 2) == ref.update_context(context, 2)
    assert got.perplexity(transcript_file, LABELS) == ref.perplexity(transcript_file, LABELS)


def test_ngram_orders_the_jax_grammar_cannot_build(transcript_file):
    """Order 3 fails in the JAX package (its back-off reads the
    normalisations while building them); the port refuses it by name."""
    with pytest.raises(AttributeError):
        JaxNGram(transcript_file, LABELS, 3)
    for order in (0, 3):
        with pytest.raises(ValueError, match="ngram_order"):
            NGram(transcript_file, LABELS, order)


def test_mof_from_logits_matches_jax_with_ties():
    rng = np.random.default_rng(0)
    got, ref = MoFAccuracyFromLogitsMetric(ignore_ids=[0]), JaxMoFFromLogits(ignore_ids=[0])
    for t in (40, 17, 1):
        # small integers: most rows have tied maxima, which go to the first index
        logits = rng.integers(0, 3, size=(t, 5)).astype(np.float32)
        targets = rng.integers(0, 5, size=t)
        want = ref.add(targets, logits)
        assert got.add(targets, logits) == want
        assert got.add(torch.from_numpy(targets), torch.from_numpy(logits)) == want
        assert got.add(targets, torch.from_numpy(logits).to(torch.bfloat16)) == want
        ref.add(targets, logits)
        ref.add(targets, logits)
    assert got.summary() == ref.summary()
    assert (got.correct, got.total) == (ref.correct, ref.total)


@pytest.mark.parametrize("case", [
    dict(T=95, transcript=[2, 0, 3], n_max=None, t_pad=None),
    dict(T=130, transcript=[1, 4, 1, 0], n_max=6, t_pad=160),
    dict(T=31, transcript=[3], n_max=None, t_pad=None),
])
def test_one_video_dense_viterbi_decode_matches_jax(case):
    rng = np.random.default_rng(case["T"])
    M = 5
    logits = rng.standard_normal((case["T"], M)).astype(np.float32) * 3
    log_probs = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
    lam = rng.uniform(5.0, 60.0, size=M).astype(np.float32)
    kw = dict(frame_sampling=10, max_len=200, n_max=case["n_max"], t_pad=case["t_pad"])
    ref = jax_dense_viterbi_decode(log_probs, case["transcript"], lam, **kw)
    got = dense_viterbi_decode(log_probs, case["transcript"], lam, device="cpu", **kw)
    np.testing.assert_allclose(got.score, ref.score, rtol=1e-5)
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert got.labels.shape == (case["T"],)
    assert [(s.label, s.length) for s in got.segments] == [
        (s.label, s.length) for s in ref.segments]
    plain = dense_viterbi_decode(log_probs, case["transcript"], lam, device="cpu",
                                 use_kernels=False, **kw)
    assert plain.score == got.score and np.array_equal(plain.labels, got.labels)


@pytest.mark.parametrize("seq", [[], [7], [4, 5, 5, 6], [1, 1, 1], [2, 3, 2, 2, 3, 3, 3]])
def test_list_helpers_match_jax(seq):
    summary, lens = summarize_list(seq)
    assert (summary, lens) == jax_utils.summarize_list(seq)
    assert unsummarize_list(summary, lens) == jax_utils.unsummarize_list(summary, lens) == seq
    labels = segment_to_labels(summary, lens)
    if seq:
        np.testing.assert_array_equal(labels, jax_utils.segment_to_labels(summary, lens))
    else:  # the JAX helper raises on empty lists (np.repeat of float64 counts)
        with pytest.raises(TypeError):
            jax_utils.segment_to_labels(summary, lens)
    np.testing.assert_array_equal(labels, seq)
    with pytest.raises(ValueError):
        unsummarize_list([1, 2], [3])
