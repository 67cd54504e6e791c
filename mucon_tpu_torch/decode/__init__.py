"""Decoding helpers of the port (mucon_tpu/decode): the grammars, the
segment-length models and the host Viterbi decoder."""

from mucon_tpu_torch.decode.grammar import (
    Grammar,
    ModifiedPathGrammar,
    NGram,
    PathGrammar,
    SingleTranscriptGrammar,
)
from mucon_tpu_torch.decode.length_model import (
    LengthModel,
    MeanLengthModel,
    MultiPoissonModel,
    PoissonModel,
    poisson_log_table,
)
from mucon_tpu_torch.decode.viterbi_host import Segment, ViterbiDecoder

__all__ = ["Grammar", "LengthModel", "MeanLengthModel", "ModifiedPathGrammar",
           "MultiPoissonModel", "NGram", "PathGrammar", "PoissonModel", "Segment",
           "SingleTranscriptGrammar", "ViterbiDecoder", "poisson_log_table"]
