"""Dense Viterbi DP kernel entry (mucon_tpu/ops/viterbi_pallas.py).

`dense_viterbi` takes the tables of `viterbi_precompute_z` and returns
(score [B], best_l [B], bps [B x K-1 x N]).  A CPU tensor takes
`dense_viterbi_plain`; a CUDA tensor launches `csrc/viterbi.cu` (one CTA
per video, the K window loop inside the kernel) or raises.  The kernel
covers both TPU formulations — the whole-batch program and the per-video
grid — and writes bp = 0 at n = 0 like the scan, where the batched TPU
kernel wrapped across videos.
"""

from __future__ import annotations

from mucon_tpu_torch.ops.viterbi import dense_viterbi_plain


def dense_viterbi(W, pois, k_valid, n_valid, frame_sampling: int, max_len: int = 2000):
    if W.device.type == "cpu":
        return dense_viterbi_plain(W, pois, k_valid, n_valid, frame_sampling, max_len)
    from mucon_tpu_torch import cuda

    return cuda.dense_viterbi(W, pois, k_valid, n_valid, frame_sampling, max_len)
