"""Dense Viterbi DP kernel entries (mucon_tpu/ops/viterbi_pallas.py).

`dense_viterbi_decode` takes the tables of `viterbi_precompute_z` and
returns (score [B], best_l [B], bps [B x K-1 x N], pos [B x K]): the DP
and the pointer walk to window positions that the JAX fused eval runs
after it (`traceback_positions_device`, mucon_tpu/ops/viterbi.py:405).  A
CPU tensor takes the plain twins `dense_viterbi_plain` and
`traceback_positions`; a CUDA tensor launches `csrc/viterbi.cu` (the DP
and the walk in one launch, on the body `cuda.viterbi_plan` picks) or
raises.
The kernel covers both TPU formulations — the whole-batch program and the
per-video grid — and writes bp = 0 at n = 0 like the scan, where the
batched TPU kernel wrapped across videos.  `dense_viterbi` is the DP's
three outputs alone.
"""

from __future__ import annotations

from mucon_tpu_torch.ops.viterbi import dense_viterbi_plain, traceback_positions


def dense_viterbi_decode(W, pois, k_valid, n_valid, frame_sampling: int,
                         max_len: int = 2000):
    if W.device.type == "cpu":
        score, best_l, bps = dense_viterbi_plain(W, pois, k_valid, n_valid, frame_sampling,
                                                 max_len)
        return score, best_l, bps, traceback_positions(bps, k_valid, n_valid, best_l)
    from mucon_tpu_torch import cuda

    return cuda.dense_viterbi_decode(W, pois, k_valid, n_valid, frame_sampling, max_len)


def dense_viterbi(W, pois, k_valid, n_valid, frame_sampling: int, max_len: int = 2000):
    if W.device.type == "cpu":
        return dense_viterbi_plain(W, pois, k_valid, n_valid, frame_sampling, max_len)
    from mucon_tpu_torch import cuda

    return cuda.dense_viterbi(W, pois, k_valid, n_valid, frame_sampling, max_len)
