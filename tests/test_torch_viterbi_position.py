"""PyTorch port: the dense Viterbi DP walked by transcript positions
(`ops/viterbi.py dense_viterbi_by_position`, the plain twin of
csrc/viterbi.cu's position body: rows in sequence, each row's entry windows
walked independently, unreached cells as NEG, frozen windows copied) against
the JAX DP — the scan from log-probs (`_dense_viterbi_scan_batched`) and on
tables (`_dense_viterbi_from_tables`), the batched Pallas kernel in
interpret mode — and against `dense_viterbi_plain`, bit for bit, on seeded
tables with exact ties (integer tables), n_valid 0, 1, N and past N,
k_valid 0, 1, K and past K (frozen windows), frame sampling 1, 2, 3, 5 and
L up to and past max_len / S; and the coverage of the position body's
split of a row (`cuda.viterbi_position_tasks`, which is pure Python)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.ops import viterbi as jv
from mucon_tpu.ops.viterbi_pallas import dense_viterbi_pallas_batched
from mucon_tpu_torch import cuda
from mucon_tpu_torch.ops.viterbi import NEG, dense_viterbi_by_position, dense_viterbi_plain

torch.set_num_threads(1)

# (K, N, L, S, max_len, ties): L at max_len / S and below it, at each frame
# sampling; L past max_len / S (cells that may not grow); K = 1; N = 1; N
# near K (infeasible videos)
CASES = [(24, 6, 30, 1, 30, True), (24, 6, 20, 1, 30, False), (30, 5, 15, 2, 30, True),
         (40, 4, 12, 3, 36, True), (40, 4, 8, 5, 40, False), (20, 5, 25, 1, 18, False),
         (1, 3, 10, 1, 10, True), (12, 1, 10, 2, 20, True), (9, 7, 6, 3, 20, True)]
IDS = ["S1_full", "S1_short", "S2_ties", "S3_ties", "S5", "L_past_max", "K1", "N1", "N_near_K"]


def _edges(K, N):
    """k_valid, n_valid of six videos: K, 0, 1, past K, K - 1, K / 2 and
    N, 0, 1, past N, N - 1, N / 2."""
    kv = np.array([K, 0, 1, K + 2, max(K - 1, 0), K // 2], np.int32)
    nv = np.array([N, 0, 1, N + 1, max(N - 1, 1), N // 2], np.int32)
    return kv, nv


def _tables(K, N, L, S, max_len, ties, seed):
    """Six videos' W [6, K, N] (three labels: exact ties between positions)
    and pois [6, N, L] (NEG where (l + 1) S >= max_len); integers with
    `ties`."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 3, size=(6, N))
    per_label = -rng.rand(K, 3).astype(np.float32) * 40.0
    W = np.ascontiguousarray(per_label[:, labels].transpose(1, 0, 2))
    pois = (-rng.rand(6, N, L) * 15.0).astype(np.float32)
    if ties:
        W, pois = np.round(W), np.round(pois)
    pois[:, :, (np.arange(L) + 1) * S >= max_len] = NEG
    return W, pois, *_edges(K, N)


def _by_position(W, pois, kv, nv, S, max_len):
    return [a.numpy() for a in dense_viterbi_by_position(
        *(torch.from_numpy(a) for a in (W, pois, kv, nv)), S, max_len)]


@pytest.mark.parametrize("K,N,L,S,max_len,ties", CASES, ids=IDS)
def test_by_position_matches_plain(K, N, L, S, max_len, ties):
    W, pois, kv, nv = _tables(K, N, L, S, max_len, ties, seed=K * 11 + N + S)
    got = _by_position(W, pois, kv, nv, S, max_len)
    want = dense_viterbi_plain(*(torch.from_numpy(a) for a in (W, pois, kv, nv)), S, max_len)
    for a, b in zip(got, want):
        assert a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.numpy().view(np.uint8))


@pytest.mark.parametrize("K,N,L,S,max_len,ties", CASES, ids=IDS)
def test_by_position_matches_scan_on_tables(K, N, L, S, max_len, ties):
    W, pois, kv, nv = _tables(K, N, L, S, max_len, ties, seed=K * 13 + N + S)
    score, best_l, bps = _by_position(W, pois, kv, nv, S, max_len)
    fn = jax.vmap(partial(jv._dense_viterbi_from_tables, frame_sampling=S,
                          max_len=max_len, n_max=N, l_max=L))
    s_score, s_bestl, s_bps, _ = (np.asarray(a) for a in fn(
        jnp.asarray(W), jnp.asarray(pois), jnp.asarray(kv), jnp.asarray(nv)))
    np.testing.assert_array_equal(score, s_score)
    np.testing.assert_array_equal(best_l, s_bestl)
    np.testing.assert_array_equal(bps, s_bps[:, :K - 1])


@pytest.mark.interpret
@pytest.mark.parametrize("K,N,L,S,max_len,ties", CASES, ids=IDS)
def test_by_position_matches_pallas_batched(K, N, L, S, max_len, ties):
    W, pois, kv, nv = _tables(K, N, L, S, max_len, ties, seed=K * 17 + N + S)
    score, best_l, bps = _by_position(W, pois, kv, nv, S, max_len)
    k_score, k_bestl, k_bps = (np.array(a) for a in dense_viterbi_pallas_batched(
        jnp.asarray(W), jnp.asarray(pois), jnp.asarray(kv), jnp.asarray(nv),
        frame_sampling=S, max_len=max_len, interpret=True))
    np.testing.assert_array_equal(score, k_score)
    np.testing.assert_array_equal(best_l, k_bestl)
    # the TPU kernel wraps the previous video's last position into column 0,
    # which the scan and the port define as 0
    np.testing.assert_array_equal(bps[:, :, 1:], k_bps[:, :, 1:])
    assert not bps[:, :, 0].any()


# (T_pad, N, S, max_len, l_max, ties): log-probs of integers (exact window
# sums, ties) or not, at frame sampling 1, 2, 3, 5
SCAN_CASES = [(60, 5, 1, 40, 40, True), (60, 6, 2, 40, 20, False), (90, 4, 3, 60, 20, True),
              (100, 5, 5, 80, 16, True)]


@pytest.mark.parametrize("T_pad,N,S,max_len,l_max,ties", SCAN_CASES,
                         ids=["S1", "S2", "S3", "S5"])
def test_by_position_matches_scan_batched(T_pad, N, S, max_len, l_max, ties):
    """The JAX scan from log-probs, on the tables its own precompute makes."""
    rng = np.random.RandomState(T_pad + N + S)
    B, M = 6, 4
    lp = rng.randn(B, T_pad, M).astype(np.float32) * 3.0
    if ties:
        lp = np.round(lp)
    K = T_pad // S
    t_valid = np.array([T_pad, 0, S, S + 1, T_pad - 2 * S - 1, T_pad // 2], np.int32)
    n_valid = _edges(K, N)[1]
    transcripts = rng.randint(0, M, size=(B, N)).astype(np.int32)
    lam = (5.0 + 30.0 * rng.rand(B, M)).astype(np.float32)
    static = dict(frame_sampling=S, max_len=max_len, n_max=N, l_max=l_max)
    args = [jnp.asarray(a) for a in (lp, t_valid, transcripts, n_valid, lam)]
    s_score, s_bestl, s_bps, s_kv = (np.asarray(a) for a in
                                     jv._dense_viterbi_scan_batched(*args, **static))
    pre = jax.jit(jax.vmap(partial(jv.viterbi_precompute, frame_sampling=S, max_len=max_len,
                                   l_max=l_max)))
    W, pois, kv = (np.array(a) for a in pre(args[0], args[1], args[2], args[4]))
    np.testing.assert_array_equal(kv, s_kv)
    score, best_l, bps = _by_position(W, pois, kv.astype(np.int32), n_valid, S, max_len)
    np.testing.assert_array_equal(score, s_score)
    np.testing.assert_array_equal(best_l, s_bestl)
    np.testing.assert_array_equal(bps, s_bps[:, :K - 1])


def test_by_position_signed_zeros_and_unreached_rows():
    """Integer tables of -0.0 and +0.0 (ties between the two zeros, which
    keep the first index): equal to the plain DP; rows past the windows
    (n >= K) are unreached, their backpointers the unreached cells' first
    argmax."""
    K, N, L, S, max_len = 5, 9, 6, 1, 6
    rng = np.random.RandomState(0)
    W = np.round(-rng.rand(6, K, N).astype(np.float32) * 0.4)
    pois = np.round(rng.rand(6, N, L).astype(np.float32) * 0.4 - 0.2)
    pois[:, :, (np.arange(L) + 1) * S >= max_len] = NEG
    kv, nv = _edges(K, N)
    got = _by_position(W, pois, kv, nv, S, max_len)
    want = dense_viterbi_plain(*(torch.from_numpy(a) for a in (W, pois, kv, nv)), S, max_len)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())
    assert np.signbit(W).all() and np.signbit(pois).any() and not np.signbit(pois).all()


# (kend, js, lmax, entries): rows with every entry live, with the first
# entries NEG, with short and long cells (lmax below and past kend), the
# frame_sampling 1 and 3 shapes, a row of one entry and one past a task
@pytest.mark.parametrize("kend,js,lmax", [
    (1, 0, 0), (2, 1, 5), (85, 0, 65), (85, 29, 65), (200, 70, 19), (333, 0, 332),
    (2000, 0, 1999), (2000, 29, 1999), (666, 3, 665), (40, 0, 1999), (129, 128, 0),
    (700, 650, 699)])
@pytest.mark.parametrize("entries", cuda.VITERBI_ENTRIES)
def test_position_split_covers_every_reachable_cell_once(kend, js, lmax, entries):
    """The position body's tasks (`cuda.viterbi_position_tasks`, the
    kernel's dealing) take every reachable cell of a row — entry j in
    [js, kend), length l in [0, min(lmax, kend - 1 - j)] — exactly once,
    each task once; a task's partials (lane 0's at each step, then every
    lane's slots after the last) reach each of its targets once; the four
    schedulers' issued steps lie within 1.5x of one another at 16 tasks or
    more."""
    tasks = cuda.viterbi_position_tasks(kend, js, lmax, entries)
    span = 32 * entries
    starts = sorted(j0 for w in tasks for j0, _ in w)
    jb = js - js % span
    assert starts == list(range(jb, kend, span))
    cells = {}
    for w in tasks:
        for j0, l_last in w:
            assert l_last == min(lmax, kend - 1 - j0)
            targets = [j0 + l for l in range(l_last + 1)]  # ring: lane 0, step l
            for t in range(32):
                base = j0 + entries * t
                targets += [base + l_last + 1 + i for i in range(entries)]  # slots left
                for r in range(entries):
                    j = base + r
                    for l in range(l_last + 1):
                        if js <= j < kend and j + l < kend:
                            cells[(j, l)] = cells.get((j, l), 0) + 1
            assert sorted(targets) == list(range(j0, j0 + span + l_last + 1))
    want = {(j, l) for j in range(js, kend) for l in range(min(lmax, kend - 1 - j) + 1)}
    assert set(cells) == want and set(cells.values()) <= {1}
    load = [sum(l_last + 1 for w in tasks[s::4] for _, l_last in w) for s in range(4)]
    if len(starts) >= 16:
        assert max(load) <= 1.5 * min(load)
