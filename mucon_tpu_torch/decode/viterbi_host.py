"""Host-side (numpy) Viterbi decoder (mucon_tpu/decode/viterbi_host.py:44).

The general hypothesis-expansion DP, for any grammar.  For a
`SingleTranscriptGrammar` it is the score oracle of the dense DP
(`ops/viterbi.py`, `csrc/viterbi.cu`); the evaluator runs it only when
`evaluator.viterbi.backend="host"` asks for it.

Behaviour of the reference implementation (its
src/core/viterbi/viterbi.py), kept because the vit_* metrics depend on it:

* windows of `frame_sampling` frames are scored by cumulative sums; the
  first window ends at frame `frame_sampling - 1`;
* on a label transition at window k, the window's frame score goes to the
  OLD label while the traceback node (and so the emitted labels of that
  window) carries the NEW label: a one-window skew;
* the `T mod frame_sampling` remainder frames carry the LAST segment's
  label but are placed at the START of the returned labels, while the
  remainder's length is added to the last segment;
* hypotheses are pruned by (score, state key), keeping the top
  `max_hypotheses`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from mucon_tpu_torch.decode.grammar import Grammar
from mucon_tpu_torch.decode.length_model import LengthModel
from mucon_tpu_torch.ops.viterbi import Segment


class ViterbiDecoder:
    """Grammar- and length-model-constrained decode of framewise log-probs."""

    def __init__(self, grammar: Optional[Grammar], length_model: Optional[LengthModel],
                 frame_sampling: int = 1, max_hypotheses: float = np.inf):
        self.grammar = grammar
        self.length_model = length_model
        self.frame_sampling = frame_sampling
        self.max_hypotheses = max_hypotheses

    def decode(self, log_frame_probs: np.ndarray):
        """(score, framewise labels list, [Segment, ...]) of [T x C] log-probs."""
        assert log_frame_probs.shape[1] == self.grammar.n_classes()
        S = self.frame_sampling
        n_frames = log_frame_probs.shape[0]
        cum = np.cumsum(log_frame_probs, axis=0)

        def window_score(t: int, label: int) -> float:
            if t >= S:
                return cum[t, label] - cum[t - S, label]
            return cum[t, label]

        # traceback arena: (label, parent index, is_boundary)
        nodes: List[Tuple[int, int, bool]] = []
        # (context incl. the current label, segment length) -> (score, node)
        start_ctx = (self.grammar.start_symbol(),)
        hyps: Dict[Tuple[Tuple[int, ...], int], Tuple[float, int]] = {}
        for label in self.grammar.possible_successors(start_ctx):
            sc = self.grammar.score(start_ctx, label) + window_score(S - 1, label)
            nodes.append((label, -1, True))
            self._keep_best(hyps, (start_ctx + (label,), S), sc, len(nodes) - 1)

        for t in range(2 * S - 1, n_frames, S):
            new_hyps: Dict[Tuple[Tuple[int, ...], int], Tuple[float, int]] = {}
            for (ctx, length), (score, node) in hyps.items():
                label = ctx[-1]
                w = window_score(t, label)
                if length + S <= self.length_model.max_length():  # continue the segment
                    nodes.append((label, node, False))
                    self._keep_best(new_hyps, (ctx, length + S), score + w, len(nodes) - 1)
                len_score = self.length_model.score(length, label)
                for nxt in self.grammar.possible_successors(ctx):  # or move on
                    if nxt == self.grammar.end_symbol():
                        continue
                    sc = score + w + len_score + self.grammar.score(ctx, nxt)
                    nodes.append((nxt, node, True))
                    self._keep_best(new_hyps, (ctx + (nxt,), S), sc, len(nodes) - 1)
            hyps = new_hyps
            self._prune(hyps)

        best_score, best_node = -np.inf, -1
        for (ctx, length), (score, node) in hyps.items():  # to the end symbol
            sc = (score + self.length_model.score(length, ctx[-1])
                  + self.grammar.score(ctx, self.grammar.end_symbol()))
            if sc >= best_score:
                best_score, best_node = sc, node

        labels, segments = self._traceback(nodes, best_node, n_frames)
        return best_score, labels, segments

    @staticmethod
    def _keep_best(hyps, key, score, node) -> None:
        if key not in hyps or hyps[key][0] <= score:
            hyps[key] = (score, node)

    def _prune(self, hyps) -> None:
        if len(hyps) > self.max_hypotheses:
            ranked = sorted((v[0], k) for k, v in hyps.items())
            for _, key in ranked[: len(hyps) - int(self.max_hypotheses)]:
                del hyps[key]

    def _traceback(self, nodes, node_idx: int, n_frames: int):
        S = self.frame_sampling
        if node_idx < 0:  # no surviving hypothesis
            return [0] * n_frames, [Segment(0, n_frames)]
        newest_label = nodes[node_idx][0]

        rev_labels: List[int] = []  # newest -> oldest
        segments: List[Segment] = [Segment(nodes[node_idx][0], 0)]
        idx = node_idx
        while idx != -1:
            label, parent, boundary = nodes[idx]
            segments[-1].length += S
            rev_labels.extend([label] * S)
            if boundary and parent != -1:
                segments.append(Segment(nodes[parent][0], 0))
            idx = parent

        # the remainder frames carry the newest label but land at the START
        remainder = n_frames - len(rev_labels)
        segments[0].length += remainder
        rev_labels.extend([newest_label] * remainder)
        return list(reversed(rev_labels)), list(reversed(segments))

