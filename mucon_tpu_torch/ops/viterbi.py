"""Dense single-transcript Viterbi: tables, plain DP, pointer walk
(mucon_tpu/ops/viterbi.py).

For a single-transcript grammar the hypothesis space is exactly
(position n < N in the transcript, current segment length l < L in
windows of `frame_sampling` frames): a dense [N x L] table advanced once
per window.  Score semantics are the JAX package's, which are bit-matched
to the reference DP (old-label window attribution on transitions, the
Poisson round/floor normaliser quirk, remainder frames placed first).

Everything is batched over videos with an explicit leading B axis.
`dense_viterbi_plain` is the twin of `_dense_viterbi_from_tables`
(viterbi.py:170) and the reference of the CUDA kernel
(`ops/viterbi_dp.py`); `dense_viterbi_by_position` walks the same DP in
the order of the kernel's position body.  The tables come from full-T
log-probs (`viterbi_precompute`, the evaluator's per-batch path) or from
the pre-upsample ones (`viterbi_precompute_z`, the fused eval).
`dense_viterbi_decode` decodes one video through the batched path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from mucon_tpu_torch import resolve_device

NEG = -1e30  # -inf stand-in that survives f32 arithmetic


@dataclass
class Segment:
    """One decoded segment (mucon_tpu/decode/viterbi_host.py:39)."""

    label: int
    length: int


@dataclass
class DenseDecodeResult:
    score: float
    labels: np.ndarray  # [T] framewise labels
    segments: List[Segment]


def _poisson_rows(lam, lengths):
    """log Poisson(l; lam) with the reference's normaliser quirk: round(lam)
    everywhere except the factorial term, which truncates (viterbi.py:47).
    lam [...], lengths [L] -> [..., L].  torch.round is round-half-even,
    like jnp.round."""
    lam = lam.to(torch.float32)
    r = torch.round(lam)
    norms = r * torch.log(r) - r - torch.lgamma(torch.floor(lam) + 1.0)
    lengths = lengths.to(torch.float32)
    logfak = torch.lgamma(lengths + 1.0)
    out = (
        lengths * torch.log(lam)[..., None]
        - lam[..., None]
        - logfak
        - norms[..., None]
    )
    return torch.where(lengths > 0, out, NEG)


def viterbi_precompute(
    log_probs,  # [B x T_pad x M] framewise log-probs
    t_valid,  # [B]
    transcripts,  # [B x N]
    class_lambdas,  # [B x M]
    *,
    frame_sampling: int,
    max_len: int,
    l_max: int,
):
    """DP tables from full-T log-probs (viterbi.py:65): W [B x K x N] the
    window sums (each window's frames summed directly, not by cumsum
    differences), pois [B x N x L], k_valid [B]."""
    S = frame_sampling
    B, T_pad, M = log_probs.shape
    K = T_pad // S
    wsum = log_probs[:, : K * S].reshape(B, K, S, M).sum(dim=2)  # [B x K x M]
    tr = torch.clamp(transcripts, 0, M - 1)
    W = torch.gather(wsum, 2, tr[:, None, :].expand(B, K, tr.shape[1]))
    lens = (torch.arange(l_max, device=log_probs.device) + 1) * S
    lam = torch.gather(class_lambdas, 1, tr)  # [B x N]
    pois = torch.where(lens < max_len, _poisson_rows(lam, lens), NEG)
    return W, pois, t_valid // S


def viterbi_precompute_z(
    log_probs_z,  # [B x Tz x M] pre-upsample framewise log-probs
    up_idx,  # [B x T_pad] monotone nearest-upsample source indices
    t_valid,  # [B]
    transcripts,  # [B x N]
    class_lambdas,  # [B x M]
    *,
    frame_sampling: int,
    max_len: int,
    l_max: int,
):
    """DP tables from the pre-upsample logits (viterbi.py:94): the window
    sums of the upsampled log-probs are C @ lp_z, with C[k, s] the count of
    window k's frames whose source index is s.  Returns W [B x K x N],
    pois [B x N x L], k_valid [B]."""
    S = frame_sampling
    B, Tz, M = log_probs_z.shape
    K = up_idx.shape[1] // S
    k_valid = t_valid // S
    idx_w = up_idx[:, : K * S].reshape(B, K, S)
    counts = log_probs_z.new_zeros(B, K, Tz).scatter_add_(
        2, idx_w, log_probs_z.new_ones(B, K, S)
    )  # exact integer counts
    wsum = torch.bmm(counts, log_probs_z)  # [B x K x M]
    tr = torch.clamp(transcripts, 0, M - 1)
    W = torch.gather(wsum, 2, tr[:, None, :].expand(B, K, tr.shape[1]))

    lens = (torch.arange(l_max, device=log_probs_z.device) + 1) * S
    lam = torch.gather(class_lambdas, 1, tr)  # [B x N]
    pois = torch.where(lens < max_len, _poisson_rows(lam, lens), NEG)
    return W, pois, k_valid


def dense_viterbi_plain(W, pois, k_valid, n_valid, frame_sampling: int, max_len: int = 2000):
    """Plain PyTorch dense DP, batched.  W [B x K x N], pois [B x N x L],
    k_valid/n_valid [B] -> (score [B], best_l [B], bps [B x K-1 x N] int32).
    Argmax ties go to the FIRST index; bp = 0 at n = 0 (no predecessor)."""
    S = frame_sampling
    B, K, N = W.shape
    L = pois.shape[2]
    dev = W.device
    l_ids = torch.arange(L, device=dev)
    valid_n = torch.arange(N, device=dev)[None, :] < n_valid[:, None]  # [B x N]
    stay_src = ((l_ids[:-1] + 2) * S <= max_len)  # can bucket l grow to l+1?

    scores = torch.full((B, N, L), NEG, dtype=torch.float32, device=dev)
    scores[:, 0, 0] = W[:, 0, 0]
    bps = torch.zeros(B, max(K - 1, 0), N, dtype=torch.int32, device=dev)
    for k in range(1, K):
        w_k = W[:, k]  # [B x N]
        grown = torch.full_like(scores, NEG)
        grown[:, :, 1:] = torch.where(stay_src, scores[:, :, :-1], NEG)
        grown = grown + w_k[:, :, None]
        # advance (n-1, .) -> (n, 0): window + length scores of the OLD label
        ex = scores + pois
        exit_best = ex.amax(dim=2)  # [B x N]
        exit_arg = torch.where(ex == exit_best[:, :, None], l_ids, L).amin(dim=2)
        adv = torch.full_like(exit_best, NEG)
        adv[:, 1:] = exit_best[:, :-1] + w_k[:, :-1]
        adv = torch.where(valid_n, adv, NEG)
        bps[:, k - 1, 1:] = exit_arg[:, :-1].to(torch.int32)
        grown[:, :, 0] = adv
        new = torch.where(valid_n[:, :, None], grown, NEG)
        live = (k < k_valid)[:, None, None]
        scores = torch.where(live, new, scores)

    rows = torch.arange(B, device=dev)
    last_n = torch.clamp(n_valid - 1, 0, N - 1)
    fin = scores[rows, last_n] + pois[rows, last_n]  # [B x L]
    score = fin.amax(dim=1)
    best_l = torch.where(fin == score[:, None], l_ids, L).amin(dim=1)
    return score, best_l.to(torch.int32), bps


def dense_viterbi_by_position(W, pois, k_valid, n_valid, frame_sampling: int,
                              max_len: int = 2000):
    """`dense_viterbi_plain` walked by transcript positions, in the order of
    csrc/viterbi.cu's position body (its plain twin, for the tests; nothing
    on the serving path calls it).  Row n's cell at window k and length l is
    entry[n][k-l] + W[k-l+1][n] + ... + W[k][n], added left to right, with
    entry[n][j] = exit[n-1](j-1) + W[j][n-1] (row 0: W[0][0] at j = 0, NEG
    after), so the rows run in sequence and a row's entries independently.
    A cell no entry reaches holds exactly NEG in the scan (NEG + W rounds to
    NEG for |W| < 2^75), so its candidate is NEG + pois[n][l] at any window;
    entries before the row's first that is not exactly NEG join those cells.
    Rows n >= n_valid are NEG from window 1 on (row 0 keeps W[0][0] at
    window 0); bp rows from kend - 1 on (kend = clip(k_valid, 1, K)) repeat
    the argmaxes of the state at window kend - 1, which the final reads.
    Same outputs as `dense_viterbi_plain`, bit for bit."""
    S = frame_sampling
    B, K, N = W.shape
    L = pois.shape[2]
    lmax = min(max(max_len // S - 1, 0), L - 1)  # the last cell that may grow
    neg = torch.tensor(NEG, dtype=torch.float32)
    l_ids = torch.arange(L)
    score = torch.empty(B, dtype=torch.float32)
    best_l = torch.empty(B, dtype=torch.int32)
    bps = torch.zeros(B, max(K - 1, 0), N, dtype=torch.int32)
    for b in range(B):
        kv, nv = int(k_valid[b]), int(n_valid[b])
        kend = min(max(kv, 1), K)
        last = min(max(nv - 1, 0), N - 1)
        entry = torch.full((kend,), NEG, dtype=torch.float32)
        entry[0] = W[b, 0, 0]
        for n in range(N):
            p = pois[b, n].to(torch.float32)
            val = (neg + p).expand(kend, L).clone()  # [target window, l]
            if n < nv:
                live = torch.nonzero(entry != neg)
                js = int(live[0]) if len(live) else kend
                v = entry[js:].clone()  # the running sums of entries js .. kend - 1
                for l in range(min(lmax, kend - 1 - js) + 1):
                    m = kend - js - l  # entries whose window js + i + l is live
                    if l > 0:
                        v = v[:m] + W[b, js + l:kend, n]
                    val[js + l:kend, l] = v + p[l]
            elif n == 0:  # n_valid <= 0: window 0's cell, masked from window 1 on
                val[0, 0] = W[b, 0, 0] + p[0]
            E = val.amax(dim=1)
            arg = torch.where(val == E[:, None], l_ids, L).amin(dim=1)
            E = val[torch.arange(kend), arg]  # the first maximum's own bits
            if n + 1 < N:
                bps[b, :min(kend, K - 1), n + 1] = arg[:K - 1].to(torch.int32)
            if n + 1 < nv:
                nxt = torch.full((kend,), NEG, dtype=torch.float32)
                nxt[1:] = E[:-1] + W[b, 1:kend, n]
                entry = nxt
            if n == last:
                score[b], best_l[b] = E[kend - 1], int(arg[kend - 1])
        if kend < K - 1:  # frozen windows
            bps[b, kend:, 1:] = bps[b, kend - 1, 1:]
    return score, best_l, bps


def traceback_positions(bps, k_valid, n_valid, best_l):
    """Batched pointer walk on the device (viterbi.py:405): bps
    [B x K-1 x N] -> transcript position of every window [B x K] (int64).
    A plain loop over K of [B]-wide ops; gathers clamp out-of-range
    indices, which only unreachable DP states can produce."""
    B, Km1, N = bps.shape
    n = n_valid.to(torch.int64) - 1
    l = best_l.to(torch.int64) + 1
    if Km1 == 0:
        return torch.clamp(n, min=0)[:, None]
    k_valid = k_valid.to(torch.int64)
    rows = torch.arange(B, device=bps.device)
    pos = torch.empty(B, Km1 + 1, dtype=torch.int64, device=bps.device)
    for k in range(Km1, 0, -1):
        active = k < k_valid
        stay = l > 1
        idx = torch.clamp(torch.where(active & ~stay, n, 0), 0, N - 1)
        bp_l = bps[rows, k - 1, idx].to(torch.int64) + 1
        pos[:, k] = n  # the position BEFORE the update (newest first)
        n, l = (
            torch.where(active, torch.where(stay, n, n - 1), n),
            torch.where(active, torch.where(stay, l - 1, bp_l), l),
        )
    pos[:, 0] = torch.clamp(n, min=0)
    return pos


def positions_to_results(
    t_valid,  # [B] true frame counts
    transcripts,  # [B x N]
    n_valid,  # [B]
    scores,  # [B]
    pos,  # [B x K] window positions
    k_valid,  # [B]
    S: int,
) -> List[DenseDecodeResult]:
    """Expand window positions into framewise labels and segments, on the
    host in numpy (viterbi.py:450)."""
    t_valid = np.asarray(t_valid, np.int64)
    transcripts = np.asarray(transcripts, np.int64)
    n_valid = np.asarray(n_valid, np.int64)
    scores = np.asarray(scores)
    pos = np.asarray(pos, np.int64)
    k_valid = np.asarray(k_valid, np.int64)

    results = []
    for b in range(t_valid.shape[0]):
        kv, N, nf = int(k_valid[b]), int(n_valid[b]), int(t_valid[b])
        p = pos[b, :kv]
        wl = transcripts[b, np.clip(p, 0, N - 1)]
        rem = nf - kv * S

        labels = np.empty(nf, np.int64)
        labels[:rem] = wl[-1]  # remainder frames lead with the newest label
        labels[rem:] = np.repeat(wl, S)

        change = np.flatnonzero(np.diff(p)) + 1
        starts = np.concatenate(([0], change))
        ends = np.concatenate((change, [kv]))
        segments = [
            Segment(int(wl[s]), int((e - s) * S)) for s, e in zip(starts, ends)
        ]
        segments[-1].length += rem
        results.append(
            DenseDecodeResult(score=float(scores[b]), labels=labels, segments=segments)
        )
    return results


def dense_viterbi_decode_batch(
    log_probs,  # [B x T x M] numpy framewise log-probs
    t_valid,  # [B]
    transcripts,  # [B x N]
    n_valid,  # [B]
    class_lambdas,  # [B x M]
    frame_sampling: int = 30,
    max_len: int = 2000,
    device="cuda",
    use_kernels: bool = True,
) -> List[DenseDecodeResult]:
    """Batched dense decode of host log-probs on `device` (viterbi.py:267):
    the full-T tables, the DP and the pointer walk, then labels and
    segments on the host.  With `use_kernels` the DP and the walk are
    `ops/viterbi_dp.py dense_viterbi_decode` (one launch of
    `csrc/viterbi.cu` on a CUDA device, its plain twins on the CPU);
    without, the plain DP and `traceback_positions`."""
    from mucon_tpu_torch.ops import viterbi_dp

    S = frame_sampling
    device = resolve_device(device)
    ids = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)  # noqa: E731
    W, pois, k_valid = viterbi_precompute(
        torch.as_tensor(np.asarray(log_probs, np.float32), device=device), ids(t_valid),
        ids(transcripts),
        torch.as_tensor(np.asarray(class_lambdas, np.float32), device=device),
        frame_sampling=S, max_len=max_len, l_max=max_len // S,
    )
    n = ids(n_valid)
    if use_kernels:
        score, _, _, pos = viterbi_dp.dense_viterbi_decode(W, pois, k_valid, n, S, max_len)
    else:
        score, best_l, bps = dense_viterbi_plain(W, pois, k_valid, n, S, max_len)
        pos = traceback_positions(bps, k_valid, n, best_l)
    return positions_to_results(t_valid, transcripts, n_valid, score.cpu().numpy(),
                                pos.cpu().numpy(), k_valid.cpu().numpy(), S)


def dense_viterbi_decode(
    log_probs,  # [T x M] numpy framewise log-probs of one video
    transcript,  # its N action ids
    class_lambdas,  # [M]
    frame_sampling: int = 30,
    max_len: int = 2000,
    n_max: Optional[int] = None,
    t_pad: Optional[int] = None,
    device="cuda",
    use_kernels: bool = True,
) -> DenseDecodeResult:
    """Decode one video (viterbi.py:241-264): `dense_viterbi_decode_batch`
    on a batch of one, the transcript zero-padded to `n_max` and the
    log-probs to `t_pad` frames (neither changes the result).  Not the
    batched DP of `ops/viterbi_dp.py`, which has the same name there, as in
    the JAX package."""
    n = len(transcript)
    n_max = n_max or n
    log_probs = np.asarray(log_probs, np.float32)
    T = log_probs.shape[0]
    if t_pad is not None and t_pad > T:
        log_probs = np.pad(log_probs, ((0, t_pad - T), (0, 0)))
    return dense_viterbi_decode_batch(
        log_probs[None], np.array([T]), np.array([list(transcript) + [0] * (n_max - n)]),
        np.array([n]), np.asarray(class_lambdas)[None], frame_sampling=frame_sampling,
        max_len=max_len, device=device, use_kernels=use_kernels,
    )[0]
