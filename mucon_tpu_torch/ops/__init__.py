"""Kernel entry points and their plain twins (mirror mucon_tpu/ops)."""

from mucon_tpu_torch.ops.eval_fused import build_fused_eval
from mucon_tpu_torch.ops.viterbi import dense_viterbi_decode, dense_viterbi_decode_batch

__all__ = ["build_fused_eval", "dense_viterbi_decode", "dense_viterbi_decode_batch"]
