"""PyTorch port: the dense Viterbi DP with its pointer walk
(`ops/viterbi_dp.py dense_viterbi_decode`, one launch on the card; on the
CPU its plain twins) against the JAX DP — the batched Pallas kernel in
interpret mode and the scan — followed by `traceback_positions_device`,
on seeded tables with exact ties, K = 1, N = 1, k_valid < K, k_valid past
K and infeasible videos; and the launch plans of the DP (its three bodies,
forced or by the crossings) and of the flint kernel (`cuda.viterbi_plan`,
`cuda.flint_plan`), which are pure Python."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.ops import viterbi as jv
from mucon_tpu.ops.viterbi_pallas import dense_viterbi_pallas_batched
from mucon_tpu_torch import cuda
from mucon_tpu_torch.ops.viterbi import NEG, dense_viterbi_plain, traceback_positions
from mucon_tpu_torch.ops.viterbi_dp import dense_viterbi, dense_viterbi_decode

torch.set_num_threads(1)

S = 30
# (K, N, L, max_len): the default L with ties; K = 1; N = 1; a small L with
# max_len 300, where only cells l <= 8 may grow (the kernel's gated shift);
# L = 700, past the cells a warp holds (the card's position body)
CASES = [(24, 6, 66, 2000), (1, 4, 66, 2000), (12, 1, 66, 2000), (16, 5, 20, 300),
         (6, 4, 700, 2000)]
IDS = ["ties", "K1", "N1", "gated", "long_L"]


def _tables(K, N, L, seed):
    """Five videos: W from three labels (exact ties between positions),
    pois with its last length at NEG; k_valid = K, past K, < K, 0, 1;
    n_valid = N, 1, and three with more positions than windows where K is
    small (infeasible)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 3, size=(5, N))
    per_label = -rng.rand(K, 3).astype(np.float32) * 60.0
    W = np.ascontiguousarray(per_label[:, labels].transpose(1, 0, 2))  # [5, K, N]
    pois = (-rng.rand(5, N, L) * 20.0).astype(np.float32)
    pois[:, :, -1] = NEG
    k_valid = np.array([K, K + 3, K // 2, 0, 1], np.int32)
    n_valid = np.array([N, 1, N, max(N - 1, 1), N], np.int32)
    return W, pois, k_valid, n_valid


def _decode(W, pois, kv, nv, max_len):
    out = dense_viterbi_decode(*(torch.from_numpy(a) for a in (W, pois, kv, nv)), S,
                               max_len)
    return [a.numpy() for a in out]


def _walk(bps, kv, nv, best_l):
    return np.asarray(jv.traceback_positions_device(
        jnp.asarray(bps), jnp.asarray(kv), jnp.asarray(nv), jnp.asarray(best_l)))


@pytest.mark.interpret
@pytest.mark.parametrize("K,N,L,max_len", CASES, ids=IDS)
def test_decode_matches_pallas_batched_and_walk(K, N, L, max_len):
    W, pois, kv, nv = _tables(K, N, L, seed=K * 7 + N)
    score, best_l, bps, pos = _decode(W, pois, kv, nv, max_len)
    k_score, k_bestl, k_bps = (np.array(a) for a in dense_viterbi_pallas_batched(
        jnp.asarray(W), jnp.asarray(pois), jnp.asarray(kv), jnp.asarray(nv),
        frame_sampling=S, max_len=max_len, interpret=True))
    np.testing.assert_array_equal(score, k_score)
    np.testing.assert_array_equal(best_l, k_bestl)
    # the TPU kernel wraps the previous video's last position into column 0,
    # which the scan and the port define as 0; the JAX walk reads it only
    # from unreachable states, and is given it as the scan defines it
    np.testing.assert_array_equal(bps[:, :, 1:], k_bps[:, :, 1:])
    assert not bps[:, :, 0].any()
    k_bps[:, :, :1] = 0
    np.testing.assert_array_equal(pos, _walk(k_bps, kv, nv, k_bestl))


@pytest.mark.parametrize("K,N,L,max_len", CASES, ids=IDS)
def test_decode_matches_scan_and_walk(K, N, L, max_len):
    W, pois, kv, nv = _tables(K, N, L, seed=K * 5 + N)
    score, best_l, bps, pos = _decode(W, pois, kv, nv, max_len)
    fn = jax.vmap(partial(jv._dense_viterbi_from_tables, frame_sampling=S,
                          max_len=max_len, n_max=N, l_max=L))
    s_score, s_bestl, s_bps, _ = (np.asarray(a) for a in fn(
        jnp.asarray(W), jnp.asarray(pois), jnp.asarray(kv), jnp.asarray(nv)))
    np.testing.assert_array_equal(score, s_score)
    np.testing.assert_array_equal(best_l, s_bestl)
    np.testing.assert_array_equal(bps, s_bps[:, : K - 1])
    np.testing.assert_array_equal(pos, _walk(s_bps[:, : K - 1], kv, nv, s_bestl))


def test_decode_is_dp_then_walk_on_cpu():
    W, pois, kv, nv = (torch.from_numpy(a) for a in _tables(24, 6, 66, seed=3))
    got = dense_viterbi_decode(W, pois, kv, nv, S, 2000)
    score, best_l, bps = dense_viterbi_plain(W, pois, kv, nv, S, 2000)
    want = (score, best_l, bps, traceback_positions(bps, kv, nv, best_l))
    for a, b, c in zip(got, want, (*dense_viterbi(W, pois, kv, nv, S, 2000), want[3])):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert got[3].dtype == torch.int64 and got[3].shape == (5, 24)


# (B, N, L, K) -> body and walk table: the default shape; L at a lane's 72
# cells and one past; N = 32, 33 and 256; a K whose table leaves shared
# memory; K = 1; few positions (N <= 8: the position body beats the warp
# body); N = 300 at L = 2000 (the position body, where the global body ran
# before it); the position body's rows in device memory at L = 30000 and K =
# 30000
@pytest.mark.parametrize("B,N,L,K,body,lc,table", [
    (128, 30, 66, 85, "warp", 72, "shared"),
    (3, 30, 66, 85, "warp", 72, "shared"),
    (6, 4, 20, 40, "position", 0, "shared"),
    (6, 32, 72, 40, "warp", 72, "shared"),
    (6, 32, 73, 40, "cluster", 16, "global"),
    (6, 33, 66, 85, "cluster", 16, "global"),
    (6, 256, 20, 85, "cluster", 16, "global"),
    (6, 30, 66, 4000, "warp", 72, "global"),
    (6, 30, 66, 1, "warp", 72, "shared"),
    (6, 300, 2000, 40, "position", 0, "shared"),
    (6, 3, 30000, 50, "position", 0, "shared"),
    (6, 2, 20, 30000, "position", 0, "shared"),
])
def test_viterbi_plan_covers_shapes(B, N, L, K, body, lc, table):
    plan = cuda.viterbi_plan(B, N, L, K)
    assert (plan["body"], plan["lc"], plan["table"]) == (body, lc, table)
    assert plan["ctas"] == B * plan["cl"] and plan["threads"] == plan["warps"] * 32
    assert plan["threads"] == {"warp": 32, "cluster": cuda.VITERBI_BLOCK_THREADS,
                               "position": cuda.VITERBI_POS_THREADS}[body]
    if body == "warp":
        assert N <= 32 and L <= lc and plan["cl"] == 1
    elif body == "cluster":
        assert (plan["cl"], plan["tpr"], plan["rpt"]) == cuda._viterbi_cluster(N, L)
    if body == "position":
        R = plan["entries"]
        rows = plan["rows"] == "shared"
        assert rows == (max(K, L) < 30000)
        assert plan["smem"] == cuda._viterbi_position_smem(K, N, L, R, rows, table == "shared")
        assert cuda._viterbi_position_smem(K, N, L, R, True, False) > cuda.MAX_SMEM_BYTES or rows
    else:
        staged = min(cuda.VITERBI_KC, max(K - 1, 1))
        state = 0 if body == "warp" else 4 * plan["cl"] * N + 2 * N
        tab = 2 * (K - 1) * N if table == "shared" else 0
        assert plan["smem"] == 4 * (staged * N + state) + tab
        if table == "global" and body == "warp":
            assert 4 * (staged * N + state) + 2 * (K - 1) * N > cuda.MAX_SMEM_BYTES
    assert plan["smem"] <= cuda.MAX_SMEM_BYTES
    assert cuda.viterbi_plan(B, N, L) == {k: v for k, v in plan.items()
                                          if k not in ("smem", "table", "staged", "entries",
                                                       "rows")}


def test_viterbi_plan_refuses():
    for B, N, L, K in ((1, 0, 66, 85), (1, 30, 0, 85), (0, 30, 66, 85), (1, 30, 66, 0)):
        with pytest.raises(ValueError):
            cuda.viterbi_plan(B, N, L, K)
    # a body that cannot take the shape, or an entries count it is not built for
    for kw, shape in ((dict(body="warp"), (1, 33, 66, 85)),
                      (dict(body="cluster"), (1, 300, 2000, 40)),
                      (dict(body="global"), (1, 30, 66, 85)),
                      (dict(body="position", entries=3), (1, 30, 66, 85))):
        with pytest.raises(ValueError):
            cuda.viterbi_plan(*shape, **kw)


@pytest.mark.parametrize("B", [1, 3, 8, 9, 16, 33, 128, 200])
@pytest.mark.parametrize("T", [1, 64, 200, 2560])
def test_flint_plan_fills_the_card(B, T):
    plan = cuda.flint_plan(B, T, 30, 48)
    w = plan["width"]
    tiles = -(-T // cuda.FLINT_TILE)
    assert w & (w - 1) == 0 and 1 <= w <= cuda.FLINT_MAX_CL
    assert plan["ctas"] == B * w and plan["frames"] == -(-T // w)
    # within the card and the frames, and no wider power of two is
    assert w == 1 or (B * w <= cuda.SMS and w <= tiles)
    assert 2 * w > min(cuda.FLINT_MAX_CL, cuda.SMS // B, tiles)
    if (B, T) == (8, 2560):  # the train batch: 128 CTAs of 132 SMs
        assert (w, plan["ctas"]) == (16, 128)
    # the default shape's window fits one chunk
    assert (plan["nc"], plan["mc"], plan["chunks"]) == (30, 48, 1)
