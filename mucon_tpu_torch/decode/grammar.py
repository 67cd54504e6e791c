"""Transcript grammars (mucon_tpu/decode/grammar.py): the prefix-trie
grammars that `GeneralDataset` and the evaluator build.

A grammar scores p(label | context prefix) in log space and enumerates the
possible successors; a path grammar is a prefix trie over known
transcripts with 0 / -inf scores (`PathGrammar` reads them from a
transcript file); the n-gram grammar uses linear discounting.  No path of
the port builds `PathGrammar` or `NGram`: they are library API, as in the
JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

START = -1
END = -2


class Grammar:
    """Base grammar: everything allowed, all scores log(1)=0."""

    def score(self, context: Tuple[int, ...], label: int) -> float:
        return 0.0

    def n_classes(self) -> int:
        return 0

    def start_symbol(self) -> int:
        return START

    def end_symbol(self) -> int:
        return END

    def possible_successors(self, context: Tuple[int, ...]) -> Set[int]:
        return set()

    def update_context(self, context: Tuple[int, ...], label: int):
        return context + (label,)


class _PrefixTrieGrammar(Grammar):
    """Shared machinery: successor sets keyed by (START,) + prefix."""

    def __init__(self, transcripts: Sequence[Sequence[int]], num_classes: int):
        self.num_classes = num_classes
        self.successors: Dict[Tuple[int, ...], Set[int]] = {}
        for transcript in transcripts:
            seq = list(transcript) + [self.end_symbol()]
            prefix: Tuple[int, ...] = (self.start_symbol(),)
            for sym in seq:
                self.successors.setdefault(prefix, set()).add(sym)
                prefix = prefix + (sym,)

    def n_classes(self) -> int:
        return self.num_classes

    def possible_successors(self, context: Tuple[int, ...]) -> Set[int]:
        return self.successors.get(tuple(context), set())

    def score(self, context: Tuple[int, ...], label: int) -> float:
        return 0.0 if label in self.possible_successors(context) else -np.inf


def _read_transcripts(transcript_file, label2index_map: Dict[str, int]) -> List[List[int]]:
    """One transcript per line of space-separated label names, as ids (the
    text after the last newline is not a line)."""
    with open(transcript_file) as f:
        lines = f.read().split("\n")[:-1]
    return [[label2index_map[w] for w in line.split()] for line in lines]


class PathGrammar(_PrefixTrieGrammar):
    """All transcripts seen in training, loaded from a transcript file
    (grammar.py:65-76)."""

    def __init__(self, transcript_file: str, label2index_map: Dict[str, int]):
        super().__init__(_read_transcripts(transcript_file, label2index_map),
                         num_classes=len(label2index_map))


class ModifiedPathGrammar(_PrefixTrieGrammar):
    """PathGrammar built directly from integer transcripts
    (reference: grammar.py:178-191)."""

    def __init__(self, transcripts: Sequence[Sequence[int]], num_classes: int):
        super().__init__(transcripts, num_classes)


class SingleTranscriptGrammar(_PrefixTrieGrammar):
    """Grammar generating exactly one transcript — used to constrain the
    Viterbi decode to the s-head's own prediction (grammar.py:196-217).

    The state space collapses to (position-in-transcript), which is what
    makes the dense DP possible (ops/viterbi.py).
    """

    def __init__(self, transcript: Sequence[int], n_classes: int):
        super().__init__([list(transcript)], n_classes)
        self.transcript = list(transcript)


class NGram(Grammar):
    """N-gram grammar with linear discounting (grammar.py:99-191; reference
    grammar.py:40-138), of order 1 or 2: above 2 the back-off of the
    normalisations reads the normalisations while they are built, and the
    JAX package's NGram fails there (AttributeError)."""

    def __init__(self, transcript_file, label2index_map, ngram_order):
        if ngram_order not in (1, 2):
            raise ValueError(f"ngram_order must be 1 or 2, got {ngram_order}")
        self.ngram_order = ngram_order
        self.num_classes = len(label2index_map)
        self.ngrams: Dict[Tuple[int, ...], int] = {}
        self.vocabulary: Set[int] = set()
        for transcript in _read_transcripts(transcript_file, label2index_map):
            labels = [self.start_symbol()] + transcript + [self.end_symbol()]
            for pos, label in enumerate(labels):
                self.vocabulary.add(label)
                self.ngrams[()] = self.ngrams.get((), 0) + 1
                for order in range(self.ngram_order):
                    ctx = tuple(labels[max(0, pos - order) : pos + 1])
                    self.ngrams[ctx] = self.ngrams.get(ctx, 0) + 1
        self.vocabulary.discard(self.start_symbol())
        self.lambdas = self._lambdas()
        self.normalization = self._normalizations()

    def _lambdas(self) -> List[float]:
        lambdas = [0.0] * self.ngram_order
        counts = [0] * self.ngram_order
        for context, count in self.ngrams.items():
            order = len(context) - 1
            if order >= 0:
                lambdas[order] += 1 if count == 1 else 0
                counts[order] += count
        return [l / max(c, 1) for l, c in zip(lambdas, counts)]

    def _normalizations(self) -> Dict[Tuple[int, ...], float]:
        norm: Dict[Tuple[int, ...], float] = {}
        for order in range(1, self.ngram_order):
            for key in self.ngrams:
                if len(key) == order + 1:
                    context = key[:-1]
                    for w in self.vocabulary:
                        if context + (w,) not in self.ngrams:
                            h = context[:-1]
                            norm[key] = norm.get(key, 0.0) + self._probability(h, w)
        return norm

    def _probability(self, context: Tuple[int, ...], label: int) -> float:
        if context + (label,) in self.ngrams:
            p = self.ngrams[context + (label,)] / self.ngrams[context]
            return p * (1 - self.lambdas[len(context)])
        p = self._probability(context[:-1], context[-1]) / self.normalization.get(
            context + (label,), 1
        )
        return p * self.lambdas[len(context)]

    def n_classes(self) -> int:
        return self.num_classes

    def possible_successors(self, context):
        return self.vocabulary

    def score(self, context, label) -> float:
        return float(np.log(self._probability(tuple(context), label)))

    def perplexity(self, transcript_file, label2index_map) -> float:
        """Corpus perplexity exp(-mean log p) over a transcript file, each
        symbol (END included, START not as a target) scored against its
        (ngram_order - 1)-symbol context (reference grammar.py:107-122)."""
        log_pp = 0.0
        n = 0
        for transcript in _read_transcripts(transcript_file, label2index_map):
            labels = [self.start_symbol()] + transcript + [self.end_symbol()]
            for i, label in enumerate(labels):
                context = tuple(labels[max(0, i - self.ngram_order + 1) : i])
                log_pp += self.score(context, label)
                n += 1
        return float(np.exp(-log_pp / n))

    def update_context(self, context, label):
        context = context + (label,)
        if self.ngram_order == 1:
            return ()
        return tuple(context[-self.ngram_order + 1 :])
