"""Transcript grammars (mucon_tpu/decode/grammar.py): the prefix-trie
grammars that `GeneralDataset` and the evaluator build.

A grammar scores p(label | context prefix) in log space and enumerates the
possible successors; a path grammar is a prefix trie over known
transcripts with 0 / -inf scores.  `PathGrammar` (read from a transcript
file) and `NGram` are not ported: nothing on the port's path builds them.
"""

from __future__ import annotations

from typing import Dict, Sequence, Set, Tuple

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
