"""Decoding helpers of the port (mucon_tpu/decode): the grammars."""

from mucon_tpu_torch.decode.grammar import (
    Grammar,
    ModifiedPathGrammar,
    SingleTranscriptGrammar,
)

__all__ = ["Grammar", "ModifiedPathGrammar", "SingleTranscriptGrammar"]
