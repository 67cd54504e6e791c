"""PyTorch port: the kernels at every width the JAX kernels take, on the CPU.

* The Python plans of `mucon_tpu_torch.cuda` (each the mirror of its C++
  plan) take every hidden size H from 1 to 512 and, on the wide kernels,
  at 513, 600, 768, 1024, 1181 and 1447 (the JAX package's widest): the
  recurrences' cluster splits (even where CL divides H, else ragged) and,
  above H = 256, the BiLSTM's persistent plans (the units over the whole
  card's CTAs at the train and eval batches and two card sizes, the sum
  order a function of H alone) cover each product of their weight matrices
  exactly once; the stack kernels run
  C up to 512 at the next built width (128, 256, 512, zero-padded) and
  above it at a multiple of 128 (the wide bodies' slabs, padded at the end);
  the H = 128 and C = 128 plans are unchanged, and a width above the
  widest (MAX_H_WIDE = 2048) or below 1 raises a ValueError naming the limit.
  The DP's plan takes L = 2000 / frame_sampling at frame_sampling 1-3 and
  N = 300 (its position body, and its cluster body, the cells in registers
  across up to 16 CTAs, where one holds them and the crossings keep it; a
  case each side of every crossing); the flint plan
  takes every N and M in chunks of segments and classes.
* The twins in the kernels' split order (the BiLSTM's k-groups and gate-row
  groups, the decoder reverse chain's row groups and ragged ranks) against
  the JAX Pallas kernels in interpret mode at H = 100, 127 and 600, the
  BiLSTM's also at 257 and 512 (the persistent kernels' orders).
* The WaveNet and MS-TCN++ twins on channels zero-padded 48 -> 128 (what the
  CUDA wrappers run) against the JAX kernels at C = 48, the trainable
  stack's gradients too.
* Three SGD steps of the port at C = 48, H = 100 against the JAX trainer on
  its kernel route (decoder chain and flint loss in interpret mode).
* `convert.py` carrying JAX parameters across at those widths, at 256 and
  at 768.

Tolerances: the twins against the JAX kernels rtol 1e-5 / atol 2e-5 (two
frameworks summing in different orders, as tests/test_torch_lstm_train.py
and test_torch_wavenet_train.py), the decoder gradients rtol 2e-4 / atol
2e-5 (test_torch_decoder_chain.py), the eval stacks 1e-4 of max|ref|
(test_torch_wavenet_tf32.py), the train steps rtol 1e-4 / atol 1e-5
(test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.models import create_model as create_jax_model
from mucon_tpu.ops.decoder_pallas import decoder_chain
from mucon_tpu.ops.lstm_pallas import bilstm_recurrence_pallas
from mucon_tpu.ops.lstm_pallas import bilstm_recurrence_train as jax_lstm_train
from mucon_tpu.ops.mstcnpp_pallas import mstcnpp_stack_pallas
from mucon_tpu.ops.wavenet_pallas_v2 import wavenet_stack_pallas_v2
from mucon_tpu.ops.wavenet_train_pallas_v3 import _make_masks, wavenet_stack_train_v3
from mucon_tpu_torch import cuda
from mucon_tpu_torch.convert import params_to_state_dict, state_dict_to_params
from mucon_tpu_torch.models.model import create_model, model_fields_from_cfg
from mucon_tpu_torch.ops import decoder_chain as chain_mod
from mucon_tpu_torch.ops.decoder_chain import (
    DecoderChain, decoder_chain_bwd_plain, decoder_chain_cluster_plain,
)
from mucon_tpu_torch.ops.lstm_recurrence import (
    bilstm_bwd_chain_plain, bilstm_bwd_coefs_plain, bilstm_recurrence_plain,
)
from mucon_tpu_torch.ops.mstcnpp_stack import mstcnpp_stack_plain
from mucon_tpu_torch.ops.wavenet_stack import wavenet_stack_plain
from mucon_tpu_torch.ops.wavenet_stack_train import stack_plan, wavenet_stack_train_plain
from tests.test_model import D, M, NMAX, small_cfg
from tests.test_torch_train import _cfg as train_cfg
from tests.test_torch_train import _check_trajectory, collate_padded, make_sample

torch.set_num_threads(1)

WIDTHS = range(1, 513)
TOL = dict(rtol=1e-5, atol=2e-5)


# -- the plans ---------------------------------------------------------------

# the persistent kernels' CTAs a direction on an H100 SXM (132 SMs) and PCIe (114)
PERSISTENT_CTAS = (66, 57)


def persistent_order_covers(H, chain, ctas):
    """The persistent kernels' split at H on `ctas` CTAs a direction covers
    every (k-row, column) product of a direction once and each owner holds
    all four gates of its units: the CTAs' `units_of` partition H and their
    gate columns (the forward's {q H + j}, the chain's columns j of dh)
    partition the columns, at most 512 a CTA; the NK groups of KC rows (a
    multiple of 4) partition the K rows, so each group's FMA chain runs
    over its rows in order.  The order (NK, KC) is
    `bilstm_persistent_order(H)`, a function of H alone.  How a CTA tiles
    its columns and stages the rows depends on B and the card; the card
    tests check the launch report's tiles (`test_bilstm_kernel_tile_remainder`)."""
    K = 4 * H if chain else H
    nk, kc = cuda.bilstm_persistent_order(H, chain)
    assert kc % 4 == 0 and (nk - 1) * kc < K <= nk * kc, (H, chain)
    rows = [g * kc + r for g in range(nk) for r in range(kc) if g * kc + r < K]
    assert rows == list(range(K)), (H, chain)
    ctas = min(ctas, H)
    most = -(-H // ctas)
    assert (most if chain else 4 * most) <= cuda.PERSISTENT_THREADS, H
    units, cols = [], []
    for r in range(ctas):
        u = cuda.units_of(r, ctas, H)
        assert 1 <= len(u) <= most, (H, r)
        units += list(u)
        cols += list(u) if chain else [q * H + j for q in range(4) for j in u]
    assert units == list(range(H)) and sorted(cols) == list(range(len(cols)))
    assert len(cols) == (H if chain else 4 * H)
    return nk, kc


def test_bilstm_fwd_plan_covers_every_product_once():
    """Every H: up to 256 the cluster split, its CTAs (`units_of` of the
    plan's CL) partitioning the units, each taking all four gates of its
    units, a thread per (video, unit) of an 8-video tile, and the threads'
    (k-row, gate column) pairs covering w_hh [H x 4H] once each: each of
    the 4H gate columns is one thread column of one CTA, whose NK groups of
    KC <= 64 rows (registers) cover the H rows once.  Above 256 the
    persistent split (`persistent_order_covers`) on two card sizes, the
    order a function of H alone.  H = 128 keeps its plan."""
    assert cuda.bilstm_fwd_plan(128) == (8, 16, 256, 4, 32)
    for H in WIDTHS:
        cl, hs, nt, nk, kc = cuda.bilstm_fwd_plan(H)
        if H > cuda.BILSTM_NARROW_H:
            assert (cl, hs, nt) == (cuda.PERSISTENT, 0, 512), H
            assert (nk, kc) == cuda.bilstm_persistent_order(H, False)
            for ctas in PERSISTENT_CTAS:
                assert persistent_order_covers(H, False, ctas) == (nk, kc), H
            continue
        assert cl >= 1 and kc % 4 == 0 and kc <= 64, H
        rows = [k for kq in range(nk) for k in range(kq * kc, min(H, (kq + 1) * kc))]
        assert rows == list(range(H)), H
        gcols, units = [], []
        for r in range(cl):
            u = cuda.units_of(r, cl, H)
            n = len(u)
            assert 1 <= n <= hs and 8 * n <= nt and nk * 4 * n <= nt, H
            units += list(u)
            gcols += [(pc // n) * H + u.start + pc % n for pc in range(4 * n)]
        assert units == list(range(H)), H
        assert sorted(gcols) == list(range(4 * H)), H


def test_bilstm_chain_plan_covers_every_product_once():
    """Every H: up to 256 the reverse chain's CTAs partition the columns of
    dh, a thread per (video, column), and each column's NQ groups of GPQ
    gate rows cover all 4H rows once; more than 32 columns a CTA only on a
    ragged split of 512 threads.  Above 256 the persistent split
    (`persistent_order_covers`: the 4H gate rows of each column of dh once,
    the order a function of H alone).  H = 128 keeps its plan."""
    assert cuda.bilstm_chain_plan(128) == (8, 16, 16, 32)
    for H in WIDTHS:
        cl, hs, nq, gpq = cuda.bilstm_chain_plan(H)
        if H > cuda.BILSTM_NARROW_H:
            assert (cl, hs, nq, gpq) == (cuda.PERSISTENT, 0,
                                         *cuda.bilstm_persistent_order(H, True)), H
            for ctas in PERSISTENT_CTAS:
                assert persistent_order_covers(H, True, ctas) == (nq, gpq), H
            continue
        nt = 256 if 8 * (H // cuda._cluster_width(H)) <= 256 else 512  # even, else ragged
        assert gpq % 4 == 0 and nq * hs <= nt and (nt == 512 or gpq <= 128), H
        rows = [g for q in range(nq) for g in range(q * gpq, min(4 * H, (q + 1) * gpq))]
        assert rows == list(range(4 * H)), H  # every column's groups, each CTA alike
        cols = []
        for r in range(cl):
            u = cuda.units_of(r, cl, H)
            assert 1 <= len(u) <= hs, H
            cols += list(u)
        assert cols == list(range(H)), H


def test_decoder_chain_plans_cover_every_product_once():
    """Every H: the forward chain's CTAs partition the units (the ragged
    split: `units_of`, HS the largest share); the reverse chain's (even or ragged) CTAs partition them too, and
    each of a CTA's 2 HS output columns of dgate [Wih; Whh]^T takes NQ
    groups of RQ rows that cover the 4H dgate rows once, 2 HS NQ threads at
    most 256 (even, RQ <= 64 in registers) or 512 (ragged).  H = 128 keeps
    its plans."""
    assert cuda.decoder_chain_fwd_plan(128) == (8, 16, 256)
    assert cuda.decoder_chain_plan(128) == (8, 16, 8, 64)
    for H in WIDTHS:
        cl, hs, nt = cuda.decoder_chain_fwd_plan(H)
        units = [j for r in range(cl) for j in cuda.units_of(r, cl, H)]
        assert units == list(range(H)) and hs == -(-H // cl) and nt == 256, H
        cl, hs, nq, rq = cuda.decoder_chain_plan(H)
        even = (cl == cuda._cluster_width(H) and hs == H // cl and 4 <= H <= 256
                and hs % 4 == 0 and hs <= 32 and nq == 256 // (2 * hs) and rq <= 64)
        assert rq % 4 == 0 and 2 * hs * nq <= (256 if even else 512), H
        rows = [k for q in range(nq) for k in range(q * rq, min(4 * H, (q + 1) * rq))]
        assert sorted(rows) == list(range(4 * H)), H
        units = [j for r in range(cl) for j in cuda.units_of(r, cl, H)]
        assert units == list(range(H)) and max(
            len(cuda.units_of(r, cl, H)) for r in range(cl)) == hs, H


def test_decoder_chain_fwd_plan_eight_ctas_from_64():
    """No H from 64 to 2048 runs the forward chain on fewer than 8 CTAs:
    the ragged split's shares cover H once, each of ceil or floor of H / 8
    units; H = 128 keeps its even split."""
    assert cuda.decoder_chain_fwd_plan(128) == (8, 16, 256)
    for H in range(64, cuda.MAX_H_WIDE + 1):
        cl, hs, nt = cuda.decoder_chain_fwd_plan(H)
        shares = [cuda.units_of(r, cl, H) for r in range(cl)]
        assert cl >= 8 and nt == 256, H
        assert [j for u in shares for j in u] == list(range(H)), H
        assert {len(u) for u in shares} <= {H // cl, -(-H // cl)} and hs == -(-H // cl), H


def test_stack_width_covers_every_c():
    """Every C runs at the least built width not below it; the built ones
    run as they are."""
    for C in WIDTHS:
        w = cuda.stack_width(C)
        assert w in cuda.STACK_WIDTHS and w >= C and (w == 128 or w // 2 < C), C
    assert [cuda.stack_width(c) for c in (128, 256, 512)] == [128, 256, 512]


WIDE_HS = (513, 600, 768, 1024, 1181, 1447)


@pytest.mark.parametrize("H", WIDE_HS)
def test_wide_plans_cover_every_product_once(H):
    """Above H = 512 every recurrence plan is a split of CL = 8 CTAs of
    `units_of` (the forward decoder chain too, at an odd H as at an even
    one) whose (unit, gate column, k) products are covered exactly once:
    the BiLSTM forward's NK groups of KC rows cover w_hh's H rows for each
    of a CTA's 4 n gate columns, which cover all 4H columns; the reverse
    chain's NQ groups of GPQ gate rows cover 4H for each of its n columns;
    the decoder reverse chain's NQ groups of RQ rows cover 4H for each of
    its 2 n output columns (dcomb and dh parts).  The wide kernels' threads
    stride over those products, so no thread count bounds H.  The BiLSTM's
    are the persistent splits (`persistent_order_covers`), the order the
    same on every card size, equal to the cluster kernels' they replaced:
    NK = max(1, 1024 / (4 ceil(H / 8))) groups, NQ = max(1, 1024 /
    ceil(H / 8))."""
    hs8 = -(-H // 8)
    for chain, n in ((False, max(1, 1024 // (4 * hs8))), (True, max(1, 1024 // hs8))):
        orders = {persistent_order_covers(H, chain, ctas) for ctas in PERSISTENT_CTAS}
        assert orders == {(n, (-(-(4 * H if chain else H) // n) + 3) // 4 * 4)}, (H, chain)
    assert cuda.bilstm_fwd_plan(H)[:3] == (cuda.PERSISTENT, 0, 512)
    assert cuda.bilstm_chain_plan(H)[:2] == (cuda.PERSISTENT, 0)

    cl, hs, nt = cuda.decoder_chain_fwd_plan(H)
    units = [j for r in range(cl) for j in cuda.units_of(r, cl, H)]
    assert (cl, hs, nt) == (8, -(-H // 8), 256) and units == list(range(H))

    cl, hs, nq, rq = cuda.decoder_chain_plan(H)
    assert (cl, hs) == (8, -(-H // 8)) and rq % 4 == 0 and nq == max(1, 512 // hs)
    rows = [k for q in range(nq) for k in range(q * rq, min(4 * H, (q + 1) * rq))]
    assert rows == list(range(4 * H))
    cols = []
    for r in range(cl):
        u = cuda.units_of(r, cl, H)
        cols += [j for j in u] + [H + j for j in u]
    assert sorted(cols) == list(range(2 * H))


@pytest.mark.parametrize("plan", [cuda.bilstm_fwd_plan, cuda.bilstm_chain_plan,
                                  cuda.decoder_chain_fwd_plan, cuda.decoder_chain_plan,
                                  cuda.stack_width])
def test_width_outside_the_kernels_raises_naming_the_limit(plan):
    """Below 1, and (the recurrences) above MAX_H_WIDE = 2048 (above the JAX
    package's widest, 1447), a plan raises a ValueError that names the
    limit."""
    bad = (0, 2049) if plan is not cuda.stack_width else (0, -3)
    for b in bad:
        with pytest.raises(ValueError, match="2048" if b > 0 else ">= 1|from 1"):
            plan(b)
    assert cuda.MAX_H_WIDE == 2048


@pytest.mark.parametrize("C", [513, 600, 768, 1000, 2048])
def test_wide_stack_width_covers_every_c(C):
    """Above 512 a stack runs on the wide bodies at C rounded up to a
    multiple of 128: each output column lies in exactly one 128-column slab,
    and `pad_channels` pads at the end only."""
    w = cuda.stack_width(C)
    assert cuda.is_wide(w) and w % cuda.WIDE_SLAB == 0 and C <= w < C + cuda.WIDE_SLAB
    slabs = [range(n0, n0 + cuda.WIDE_SLAB) for n0 in range(0, w, cuda.WIDE_SLAB)]
    assert sorted(c for s in slabs for c in s) == list(range(w))
    t = torch.arange(2.0 * C).reshape(1, 2, C) + 1
    p = cuda.pad_channels(t, w, (2,))
    assert p.shape == (1, 2, w) and torch.equal(p[..., :C], t) and not p[..., C:].any()


# (N, L) -> the DP's body: N = 31 at frame_sampling 1, 2, 3 (L = 2000 //
# frame_sampling: the position body), N = 300 at two L a cluster holds, and
# N = 300 at L = 2000, which no cluster of 16 CTAs holds (the position body,
# where the global body ran before it)
@pytest.mark.parametrize("N,L,K,body", [(31, 2000, 2560, "position"),
                                        (31, 1000, 1280, "position"),
                                        (31, 666, 853, "position"), (300, 20, 40, "cluster"),
                                        (300, 66, 40, "cluster"), (300, 2000, 40, "position")])
def test_viterbi_plan_takes_every_state(N, L, K, body):
    """The DP takes any N and L: the cluster body where a cluster of at
    most 16 CTAs holds the [N x L] cells in registers (its threads' rows
    and 16-cell slices cover every cell, its slots and a staged window fit
    shared memory) and the crossings keep it, else the position body (one
    CTA of 512 threads a video; its row buffers, entries and keys in shared
    memory, and the walk's table where it fits beside them)."""
    plan = cuda.viterbi_plan(4, N, L, K)
    assert plan["body"] == body == cuda.viterbi_route(4, N, L)
    if body == "cluster":
        cl, tpr, rpt = plan["cl"], plan["tpr"], plan["rpt"]
        assert plan["threads"] == 256 and 1 <= plan["staged"] <= min(cuda.VITERBI_KC, K - 1)
        assert plan["lc"] == cuda.VITERBI_CELLS and plan["ctas"] == 4 * cl
        assert 1 <= cl <= cuda.VITERBI_MAX_CL and tpr & (tpr - 1) == 0 and rpt in (1, 2, 4)
        assert 256 // tpr * rpt >= N and cl * tpr * cuda.VITERBI_CELLS >= L
        assert (cl - 1) * tpr * cuda.VITERBI_CELLS < L  # every CTA holds a column
        state = 4 * cl * N + 2 * N
        assert plan["table"] == "global" and plan["smem"] == 4 * (plan["staged"] * N + state)
        assert plan["smem"] <= cuda.MAX_SMEM_BYTES
    else:
        R = plan["entries"]
        assert plan["threads"] == cuda.VITERBI_POS_THREADS and plan["ctas"] == 4
        assert R == (4 if K >= 640 else 2) and plan["rows"] == "shared"
        Kp, Lp, EB, KK = cuda._viterbi_position_layout(K, L, R)
        rows = 16 * 32 * 8 + 64 + 8 * KK + 4 * (2 * Kp + 2 * Lp + EB)
        tab = 2 * (K - 1) * N if plan["table"] == "shared" else 0
        assert plan["smem"] == rows + tab <= cuda.MAX_SMEM_BYTES
        assert plan["table"] == ("shared" if rows + 2 * (K - 1) * N <= cuda.MAX_SMEM_BYTES
                                 else "global")


# each crossing of `cuda.viterbi_route` (VITERBI_CROSSINGS and the warp
# body's, measured on the card): the body on either side of it
@pytest.mark.parametrize("B,N,L,body", [
    (6, 33, 132, "cluster"), (6, 33, 133, "position"), (6, 64, 199, "cluster"),
    (6, 64, 200, "position"), (6, 128, 399, "cluster"), (6, 128, 400, "position"),
    (6, 300, 512, "cluster"), (6, 300, 513, "position"), (128, 33, 132, "cluster"),
    (128, 33, 133, "position"), (128, 64, 199, "cluster"), (128, 64, 200, "position"),
    (128, 128, 199, "cluster"), (128, 128, 200, "position"), (128, 300, 65, "cluster"),
    (128, 300, 66, "position"), (128, 8, 20, "position"), (128, 9, 65, "warp"),
    (128, 16, 65, "warp"), (128, 16, 66, "position"), (3, 17, 72, "warp"),
    (3, 30, 66, "warp"), (3, 30, 73, "cluster"), (3, 16, 73, "position"),
    (3, 32, 133, "position")])
def test_viterbi_route_crossings(B, N, L, body):
    assert cuda.viterbi_route(B, N, L) == body == cuda.viterbi_plan(B, N, L, 85)["body"]
    # a body the route does not pick still plans where it takes the shape
    for other in ("cluster", "position"):
        if other != body and (other == "position" or cuda._viterbi_cluster(N, L)):
            assert cuda.viterbi_plan(B, N, L, 85, body=other)["body"] == other


def test_viterbi_cluster_split_covers_every_cell_once():
    """For every N up to 1024 and L at frame_sampling 1-30 (and a few
    others), the cluster body's threads cover each (row, column) cell of a
    video once: rank r, thread t takes rows t // TPR + i 256 // TPR and the
    16 columns from r 16 TPR + (t % TPR) 16; where no split of at most 16
    CTAs exists the position body takes the shape."""
    for N in (1, 2, 7, 31, 33, 64, 100, 255, 257, 300, 513, 1024, 1025):
        for L in (1, 16, 17, 66, 67, 133, 200, 400, 666, 1000, 2000, 4000):
            split = cuda._viterbi_cluster(N, L)
            if split is None:
                continue
            cl, tpr, rpt = split
            G = 256 // tpr
            cells = set()
            for r in range(cl):
                for t in range(256):
                    for i in range(rpt):
                        n = t // tpr + i * G
                        l0 = r * tpr * 16 + (t % tpr) * 16
                        cells.update((n, l) for l in range(l0, l0 + 16) if n < N and l < L)
            assert len(cells) == N * L, (N, L)


@pytest.mark.parametrize("N,M,chunks", [(30, 48, 1), (31, 48, 1), (31, 600, 2), (31, 778, 2),
                                        (482, 48, 2), (482, 778, 18)])
def test_flint_plan_chunks_cover_every_class_once(N, M, chunks):
    """The flint kernel's window in chunks (`cuda.flint_plan`): one where
    [N x M] fits a CTA's shared memory (the default shape), else chunks of
    at least 32 classes, and of segments where N alone is too large; the
    chunks cover every (segment, class) entry once, and a CTA's bytes are
    within the card's limit."""
    plan = cuda.flint_plan(8, 2560, N, M)
    nc, mc = plan["nc"], plan["mc"]
    assert plan["chunks"] == chunks and plan["smem"] == 4 * cuda.flint_floats(nc, mc)
    assert plan["smem"] <= cuda.MAX_SMEM_BYTES
    assert (nc, mc) == (N, M) or mc >= 32
    if chunks == 1:
        assert 4 * cuda.flint_floats(N, M) <= cuda.MAX_SMEM_BYTES
    else:
        assert 4 * cuda.flint_floats(N, M) > cuda.MAX_SMEM_BYTES
    entries = [(n, m) for n0 in range(0, N, nc) for m0 in range(0, M, mc)
               for n in range(n0, min(N, n0 + nc)) for m in range(m0, min(M, m0 + mc))]
    assert sorted(entries) == [(n, m) for n in range(N) for m in range(M)]
    assert len(entries) == N * M


def _fewest_flint_chunks(N, M, limit):
    """(nc, mc) by search: of the even chunks of N (the fewest first), the
    first that takes some even chunk of M of at least min(M, 32) classes
    within `limit` bytes, with the fewest chunks of M; None where none does."""
    for kn in range(1, N + 1):
        nc = -(-N // kn)
        for km in range(1, M + 1):
            mc = -(-M // km)
            if mc < min(M, cuda.FLINT_MIN_CLASSES):
                break
            if 4 * cuda.flint_floats(nc, mc) <= limit:
                return nc, mc
    return None


@pytest.mark.parametrize("limit", [232448, 50000, 20000, 8000])
def test_flint_plan_takes_the_fewest_chunks(monkeypatch, limit):
    """`cuda.flint_plan`'s closed form gives the search's chunks, and raises
    exactly where the search finds none, at the card's limit and three
    smaller ones (the smallest leaves no room for M = 600's chunks)."""
    monkeypatch.setattr(cuda, "MAX_SMEM_BYTES", limit)
    shapes = [(N, M) for N in (*range(1, 41, 3), 241, 480, 482, 777, 1500)
              for M in (*range(1, 100, 7), 300, 600, 778, 2000)]
    for N, M in shapes:
        want = _fewest_flint_chunks(N, M, limit)
        if want is None:
            with pytest.raises(ValueError, match="MAX_SMEM_BYTES"):
                cuda.flint_plan(8, 2560, N, M)
        else:
            plan = cuda.flint_plan(8, 2560, N, M)
            assert (plan["nc"], plan["mc"]) == want, (N, M)


def test_flint_plan_past_every_chunk_raises_naming_the_limit(monkeypatch):
    """Where even a chunk of one segment by the fewest classes does not fit
    (a card with less shared memory than a chunk needs), the plan raises a
    ValueError that names the limit, not a launch error."""
    monkeypatch.setattr(cuda, "MAX_SMEM_BYTES", 4 * cuda.flint_floats(1, 32) - 4)
    with pytest.raises(ValueError, match="MAX_SMEM_BYTES"):
        cuda.flint_plan(8, 2560, 31, 600)
    with pytest.raises(ValueError, match=">= 1"):
        cuda.flint_plan(8, 2560, 0, 48)


def test_pad_channels_pads_at_the_end_only():
    t = torch.arange(6.0).reshape(1, 2, 3)
    p = cuda.pad_channels(t, 5, (2,))
    assert p.shape == (1, 2, 5) and torch.equal(p[..., :3], t) and not p[..., 3:].any()
    assert cuda.pad_channels(t, 3, (2,)) is t and cuda.pad_channels(None, 5, (0,)) is None


# -- the split-order twins against the JAX kernels ----------------------------

def _lstm_inputs(T, B, H, valid, seed):
    rng = np.random.RandomState(seed)
    xp = rng.randn(T, 2, B, 4 * H).astype(np.float32)
    w_hh = (rng.randn(2, H, 4 * H) / np.sqrt(H)).astype(np.float32)
    m = (np.arange(T)[:, None] < np.asarray(valid)[None, :]).astype(np.float32)
    cts = [rng.randn(*s).astype(np.float32) for s in ((T, 2, B, H), (2, B, H), (2, B, H))]
    return xp, m, w_hh, cts


@pytest.mark.interpret
@pytest.mark.parametrize("H", [100, 127, 257, 512, 600])
def test_bilstm_split_order_twins_match_jax(H):
    """The forward in its k-group order (`bilstm_fwd_plan`), the coefficient
    pass in the same order and the chain in its gate-row order
    (`bilstm_chain_plan`), composed into dxp and dw_hh, against the JAX eval
    kernel and `jax.vjp` of its train kernel; the grouped twins also match
    the ungrouped ones."""
    T, B, valid = 6, 3, (6, 4, 0)
    xp, m, w_hh, cts = _lstm_inputs(T, B, H, valid, seed=H)
    _, _, _, nk, kc = cuda.bilstm_fwd_plan(H)
    gpq = cuda.bilstm_chain_plan(H)[3]
    ref_eval = bilstm_recurrence_pallas(*map(jnp.asarray, (xp, m, w_hh)), interpret=True)
    ref, vjp = jax.vjp(lambda a, w: jax_lstm_train(True, a, jnp.asarray(m), w),
                       jnp.asarray(xp), jnp.asarray(w_hh))
    dxp_ref, dw_ref = vjp(tuple(map(jnp.asarray, cts)))

    xt, mt, wt = map(torch.from_numpy, (xp, m, w_hh))
    ct = [torch.from_numpy(c) for c in cts]
    outs, h, c, cs = bilstm_recurrence_plain(xt, mt, wt, stash=True, k_groups=(nk, kc))
    for got, want, want_eval in zip((outs, h, c), ref, ref_eval):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_eval), **TOL)
    coefs = bilstm_bwd_coefs_plain(xt, mt, wt, outs, cs, k_groups=(nk, kc))
    np.testing.assert_allclose(coefs.numpy(),
                               bilstm_bwd_coefs_plain(xt, mt, wt, outs, cs).numpy(), **TOL)
    dxp = bilstm_bwd_chain_plain(coefs, mt, wt, *ct, row_groups=gpq)
    h_prev = torch.cat([torch.zeros_like(outs[:1]), outs[:-1]])
    dw = torch.einsum("tdbh,tdbg->dhg", h_prev, dxp)
    np.testing.assert_allclose(dxp.numpy(), np.asarray(dxp_ref), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_ref), **TOL)
    np.testing.assert_allclose(dxp.numpy(), bilstm_bwd_chain_plain(coefs, mt, wt, *ct).numpy(),
                               **TOL)


def _chain_inputs(H, seed, S=5, Tz=9, valid=(9, 6, 2)):
    rng = np.random.RandomState(seed)
    E = 2 * H
    r = lambda *sh: (rng.randn(*sh) * 0.4).astype(np.float32)  # noqa: E731
    w = lambda k, *sh: (rng.randn(*sh) / np.sqrt(k)).astype(np.float32)  # noqa: E731
    b = len(valid)
    maskf = (np.arange(Tz)[None, :] < np.array(valid)[:, None]).astype(np.float32)
    return [np.maximum(r(S, b, H), 0.0), r(b, Tz, E) * maskf[:, :, None], r(b, Tz, H), maskf,
            r(b, H), r(b, H), w(H, H, H), r(H), r(H), w(H + E, H, H), w(H + E, E, H), r(H),
            w(2 * H, H, 4 * H), w(2 * H, H, 4 * H), r(4 * H)]


@pytest.mark.interpret
@pytest.mark.parametrize("H", [100, 127, 600])
def test_decoder_chain_split_order_twins_match_jax(H, monkeypatch):
    """The forward by the cluster's ranks of frames (`decoder_chain_fwd_plan`'s
    CL) and `DecoderChain`'s every input gradient with its reverse chain in
    the kernel's order (`decoder_chain_plan`: row groups, ragged ranks)
    against the JAX kernel in interpret mode and `jax.grad` through it."""
    args = _chain_inputs(H, seed=H)
    S, B = args[0].shape[:2]
    cl = cuda.decoder_chain_fwd_plan(H)[0]
    plan = cuda.decoder_chain_plan(H)
    rng = np.random.RandomState(1)
    cts = [rng.randn(S, B, H).astype(np.float32) for _ in range(3)]
    jargs = list(map(jnp.asarray, args))
    got = decoder_chain_cluster_plain(*map(torch.from_numpy, args), cl=cl)
    for name, a, b in zip(("hs", "cs", "comb"), got, decoder_chain(True, *jargs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=name)

    def loss_kernel(*a):
        return sum(jnp.sum(o * w) for o, w in zip(decoder_chain(True, *a), cts))

    argnums = tuple(i for i in range(15) if i != 3)
    ref = jax.grad(loss_kernel, argnums=argnums)(*jargs)

    def ordered(*a):
        with torch.no_grad():
            return decoder_chain_bwd_plain(*a, plan=plan)

    monkeypatch.setattr(chain_mod, "_chain_backward", ordered)
    xs = [torch.from_numpy(a).requires_grad_(i != 3) for i, a in enumerate(args)]
    outs = DecoderChain.apply(*xs)
    sum(torch.sum(o * torch.from_numpy(w)) for o, w in zip(outs, cts)).backward()
    for i, want in zip(argnums, ref):
        np.testing.assert_allclose(xs[i].grad.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5,
                                   err_msg=str(i))


# -- the stacks on zero-padded channels ---------------------------------------

C48, STAGES, POOLS = 48, (1, 2, 4), (0, 2)
LENGTHS = np.array([64, 45, 17], np.int32)


def _stack_weights(rng, C, mstcnpp=False):
    L = len(STAGES)
    r = lambda k, *sh: (rng.randn(*sh) / np.sqrt(k)).astype(np.float32)  # noqa: E731
    b = lambda *sh: (0.1 * rng.randn(*sh)).astype(np.float32)  # noqa: E731
    if mstcnpp:
        return [r(3 * C, L, 3, C, C), b(L, C), r(3 * C, L, 3, C, C), b(L, C), r(2 * C, L, C, C),
                r(2 * C, L, C, C), b(L, C), r(C, C, C), b(C)]
    return [r(3 * C, L, 3, C, C), b(L, C), r(C, L, C, C), b(L, C), r(C, C, C), b(C)]


def _x(rng, C, T=64):
    x = np.maximum(rng.randn(len(LENGTHS), T, C), 0).astype(np.float32)
    return x * (np.arange(T)[None, :, None] < LENGTHS[:, None, None])


def _padded(C, t, dims):
    return cuda.pad_channels(t, cuda.stack_width(C), dims)


@pytest.mark.interpret
@pytest.mark.parametrize("mstcnpp", [False, True], ids=["wavenet", "mstcnpp"])
def test_padded_eval_stacks_match_jax_at_c48(mstcnpp):
    """The eval stack's twin at C = 48 zero-padded to 128 (x, the weights
    and the biases, as `cuda.wavenet_stack` / `cuda.mstcnpp_stack` pad) and
    sliced back equals the JAX kernel at 48 within 1e-4 of max|ref|, and the
    padded channels come out exactly 0."""
    rng = np.random.RandomState(3)
    x, ws = _x(rng, C48), _stack_weights(rng, C48, mstcnpp)
    lens = jnp.asarray(LENGTHS)
    if mstcnpp:
        ref, t_ref = mstcnpp_stack_pallas(jnp.asarray(x), lens, *map(jnp.asarray, ws),
                                          num_layers=len(STAGES), pooling_layers=POOLS,
                                          interpret=True)
        dims = ((2, 3), (1,), (2, 3), (1,), (1, 2), (1, 2), (1,), (0, 1), (0,))
    else:
        ref, t_ref = wavenet_stack_pallas_v2(jnp.asarray(x), lens, *map(jnp.asarray, ws),
                                             stages=STAGES, pooling_layers=POOLS,
                                             interpret=True)
        dims = ((2, 3), (1,), (1, 2), (1,), (0, 1), (0,))
    xp = _padded(C48, torch.from_numpy(x), (2,))
    wp = [_padded(C48, torch.from_numpy(w), d) for w, d in zip(ws, dims)]
    assert xp.shape[2] == 128
    with torch.no_grad():
        if mstcnpp:
            got, t_got = mstcnpp_stack_plain(xp, torch.from_numpy(LENGTHS).long(), *wp,
                                             pooling_layers=POOLS)
        else:
            got, t_got = wavenet_stack_plain(xp, torch.from_numpy(LENGTHS).long(), *wp,
                                             stages=STAGES, pooling_layers=POOLS)
    assert not got[..., C48:].any()
    ref = np.asarray(ref)
    np.testing.assert_array_equal(t_got.numpy(), np.asarray(t_ref))
    assert np.abs(got[..., :C48].numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.interpret
def test_padded_train_stack_gradients_match_jax_at_c48():
    """The trainable stack's twin on channels padded 48 -> 128 (x, weights,
    biases and dropout masks, as `cuda.wavenet_train_forward` / `_backward`
    pad) with the gradients sliced back equals `jax.vjp` of the JAX v3
    kernel at 48, dropout on; the padded channels' gradients are 0."""
    rng = np.random.RandomState(4)
    T, C, drop, seed = 64, C48, 0.25, jnp.asarray(7, jnp.int32)
    x, ws = _x(rng, C, T), _stack_weights(rng, C)
    t_ins, _, _, t_fin = stack_plan(STAGES, POOLS, T)
    g = rng.randn(len(LENGTHS), t_fin, C).astype(np.float32)

    def f(x, *w):
        return wavenet_stack_train_v3(x, jnp.asarray(LENGTHS), seed, *w, STAGES, POOLS, "max",
                                      drop, False, True, None)

    z_ref, vjp = jax.vjp(f, jnp.asarray(x), *map(jnp.asarray, ws))
    grads_ref = vjp(jnp.asarray(g))
    masks = [_padded(C, torch.from_numpy(np.array(m)), (2,))
             for m in _make_masks(seed, drop, t_ins, len(LENGTHS), C)]
    dims = ((2,), (2, 3), (1,), (1, 2), (1,), (0, 1), (0,))
    xs = [_padded(C, torch.from_numpy(a), d).requires_grad_()
          for a, d in zip([x, *ws], dims)]
    z, _ = wavenet_stack_train_plain(xs[0], torch.from_numpy(LENGTHS).long(), *xs[1:],
                                     stages=STAGES, pooling_layers=POOLS, drop_masks=masks)
    z.backward(_padded(C, torch.from_numpy(g), (2,)))
    np.testing.assert_allclose(z[..., :C].detach().numpy(), np.asarray(z_ref), **TOL)
    c = slice(0, C)
    for a, d, want in zip(xs, dims, grads_ref):
        idx = tuple(c if i in d else slice(None) for i in range(a.dim()))
        np.testing.assert_allclose(a.grad[idx].numpy(), np.asarray(want), **TOL)
        rest = a.grad.clone()
        rest[idx] = 0
        assert not rest.any()


# -- a train trajectory and the weight bridge at the widths --------------------

def _width_cfg(C, H, groups):
    cfg = train_cfg(0.0)
    cfg.model.ft.hidden_size = C
    cfg.model.ft.last_gn_num_groups = groups
    cfg.model.fs.encoder.hidden_size = H
    cfg.model.fs.decoder.hidden_size = H
    return cfg


@pytest.mark.interpret
def test_train_trajectory_matches_jax_kernel_route_at_c48_h100(tmp_path):
    """Three SGD steps of the port at C = 48, H = 100 (the ragged widths)
    against the JAX trainer with its decoder chain and flint loss kernels in
    interpret mode, from the same weights and batch."""
    cfg = _width_cfg(48, 100, 16)
    cfg.tpu.use_pallas_decoder = True
    cfg.tpu.use_pallas_loss = True
    rng = np.random.RandomState(0)
    samples = [make_sample(rng, 61, 3, "a"), make_sample(rng, 44, 5, "b"),
               make_sample(rng, 30, 2, "c")]
    batch = collate_padded(samples, n_max=NMAX, pad_multiple=16)
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0), batch))
    _check_trajectory(cfg, jm, params, batch, tmp_path)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if hasattr(v, "items") else {key: np.asarray(v)})
    return out


@pytest.mark.parametrize("ft_type", ["wavenet", "mstcnpp"])
@pytest.mark.parametrize("C,H,groups", [(48, 100, 16), (48, 127, 16), (256, 256, 32),
                                         (768, 768, 32)])
def test_convert_round_trips_at_the_widths(ft_type, C, H, groups):
    """`convert.py` carries the JAX parameters across, and back, exactly at
    the widths the kernels now take."""
    cfg = small_cfg()
    cfg.model.ft.type = ft_type
    cfg.model.ft.hidden_size = C
    cfg.model.ft.last_gn_num_groups = groups
    cfg.model.fs.encoder.hidden_size = H
    cfg.model.fs.decoder.hidden_size = H
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(2)))
    tm = create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg))
    tm.load_jax_params(params)
    sd = tm.net.state_dict()
    assert sd["fs_encoder_lstm.fwd.w_hh"].shape == (H, 4 * H)
    assert set(sd) == set(params_to_state_dict(params))
    a, b = _flatten(params), _flatten(state_dict_to_params(sd))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_twin_pool_inputs_route_like_the_given_values():
    """`wavenet_stack_plain(pool_inputs=...)`: given its own pre-pool values
    the twin is unchanged (values and gradients); given values whose pair
    order differs, its max pool routes the gradient by the given values
    while the gradient still flows through its own."""
    rng = np.random.RandomState(5)
    C = 8
    x, ws = _x(rng, C), _stack_weights(rng, C)
    lens = torch.from_numpy(LENGTHS).long()
    kw = dict(stages=STAGES, pooling_layers=POOLS)
    captured = {}

    def run(pool_inputs=None):
        xs = [torch.from_numpy(a).requires_grad_() for a in [x, *ws]]
        z, _ = wavenet_stack_plain(xs[0], lens, *xs[1:], **kw, pool_inputs=pool_inputs)
        z.sum().backward()
        return z.detach(), [t.grad for t in xs]

    import mucon_tpu_torch.ops.wavenet_stack as ws_mod
    pool = ws_mod.pool2_time

    def spy(u, kind):
        captured[len(captured)] = u.detach().clone()
        return pool(u, kind)

    ws_mod.pool2_time = spy
    try:
        z0, g0 = run()
    finally:
        ws_mod.pool2_time = pool
    own = {p: captured[k] for k, p in enumerate(POOLS)}
    z1, g1 = run(own)
    assert torch.equal(z0, z1) and all(torch.equal(a, b) for a, b in zip(g0, g1))
    swapped = {p: u.flip(1) for p, u in own.items()}  # every pair's order reversed
    z2, g2 = run(swapped)
    assert not torch.equal(z2, z0) and all(torch.isfinite(t).all() for t in g2)
