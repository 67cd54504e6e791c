"""PyTorch port: Viterbi tables, dense DP, pointer walk and label expansion
against the JAX scan, the batched Pallas kernel (interpret mode) and the
JAX host helpers."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.models.layers import nearest_upsample_indices as jax_up_idx
from mucon_tpu.ops import viterbi as jv
from mucon_tpu.ops.viterbi_pallas import dense_viterbi_pallas_batched
from mucon_tpu_torch.models.layers import nearest_upsample_indices
from mucon_tpu_torch.ops import viterbi as tv
from mucon_tpu_torch.ops.viterbi_dp import dense_viterbi

torch.set_num_threads(1)

# the shapes of tests/test_pallas.py::test_viterbi_pallas_batched_matches_scan
B, T, M, S = 4, 600, 10, 30
MAX_LEN, L, N = 2000, 2000 // 30, 6
T_VALID = np.array([600, 431, 299, 62], np.int32)
N_VALID = np.array([4, 6, 2, 1], np.int32)
SCORE_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def tables():
    rng = np.random.RandomState(7)
    log_probs = np.log(
        rng.dirichlet(np.ones(M), size=(B, T)).astype(np.float64) + 1e-8
    ).astype(np.float32)
    transcripts = rng.randint(0, M, size=(B, N)).astype(np.int32)
    lambdas = rng.uniform(20, 200, size=(B, M)).astype(np.float32)
    pre = jax.vmap(partial(jv.viterbi_precompute, frame_sampling=S,
                           max_len=MAX_LEN, l_max=L))
    W, pois, kv = pre(jnp.asarray(log_probs), jnp.asarray(T_VALID),
                      jnp.asarray(transcripts), jnp.asarray(lambdas))
    return np.array(W), np.array(pois), np.array(kv), transcripts


def _scan(W, pois, kv):
    fn = jax.vmap(partial(jv._dense_viterbi_from_tables, frame_sampling=S,
                          max_len=MAX_LEN, n_max=N, l_max=L))
    return [np.asarray(a) for a in fn(jnp.asarray(W), jnp.asarray(pois),
                                      jnp.asarray(kv), jnp.asarray(N_VALID))]


def _plain(W, pois, kv):
    args = (torch.from_numpy(W), torch.from_numpy(pois), torch.from_numpy(kv).long(),
            torch.from_numpy(N_VALID).long())
    plain = tv.dense_viterbi_plain(*args, S, MAX_LEN)
    disp = dense_viterbi(*args, S, MAX_LEN)  # CPU tensors -> plain twin
    for a, b in zip(plain, disp):
        assert torch.equal(a, b)
    return [a.numpy() for a in plain]


def test_plain_dp_matches_scan(tables):
    W, pois, kv, _ = tables
    s_score, s_bestl, s_bps, _ = _scan(W, pois, kv)
    score, best_l, bps = _plain(W, pois, kv)
    np.testing.assert_allclose(score, s_score, **SCORE_TOL)
    np.testing.assert_array_equal(best_l, s_bestl)
    np.testing.assert_array_equal(bps, s_bps)  # every column, n = 0 included


@pytest.mark.interpret
def test_plain_dp_matches_pallas_batched(tables):
    W, pois, kv, _ = tables
    k_score, k_bestl, k_bps = (np.asarray(a) for a in dense_viterbi_pallas_batched(
        jnp.asarray(W), jnp.asarray(pois), jnp.asarray(kv), jnp.asarray(N_VALID),
        frame_sampling=S, max_len=MAX_LEN, interpret=True,
    ))
    score, best_l, bps = _plain(W, pois, kv)
    np.testing.assert_allclose(score, k_score, **SCORE_TOL)
    np.testing.assert_array_equal(best_l, k_bestl)
    # the TPU kernel wraps the previous video into column 0; the port writes 0
    np.testing.assert_array_equal(bps[:, :, 1:], k_bps[:, :, 1:])
    assert not bps[:, :, 0].any()


def test_traceback_and_labels_match_jax(tables):
    W, pois, kv, transcripts = tables
    score, best_l, bps = _plain(W, pois, kv)
    pos = tv.traceback_positions(torch.from_numpy(bps), torch.from_numpy(kv),
                                 torch.from_numpy(N_VALID), torch.from_numpy(best_l))
    ref_pos = np.asarray(jv.traceback_positions_device(
        jnp.asarray(bps), jnp.asarray(kv), jnp.asarray(N_VALID), jnp.asarray(best_l)))
    np.testing.assert_array_equal(pos.numpy(), ref_pos)
    got = tv.positions_to_results(T_VALID, transcripts, N_VALID, score, pos.numpy(), kv, S)
    want = jv.host_traceback_batched(T_VALID, transcripts, N_VALID, score, best_l,
                                     bps, kv, S)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.labels, w.labels)
        assert [(s.label, s.length) for s in g.segments] == \
            [(s.label, s.length) for s in w.segments]
        assert g.score == w.score


def test_precompute_z_matches_jax():
    rng = np.random.RandomState(3)
    Bz, Tz, Tp, n = 3, 40, 640, 5
    lp_z = np.log(rng.dirichlet(np.ones(M), size=(Bz, Tz)) + 1e-8).astype(np.float32)
    nf = np.array([640, 517, 333], np.int32)
    tz = nf // 16
    trs = rng.randint(0, M, size=(Bz, n)).astype(np.int32)
    lam = rng.uniform(0.5, 300, size=(Bz, M)).astype(np.float32)
    lam[0, :3] = [1.5, 2.5, 1.0]  # round-half-even and round/floor quirk cases
    up = np.asarray(jax_up_idx(jnp.asarray(tz), Tp, jnp.asarray(nf)))
    up_t = nearest_upsample_indices(torch.from_numpy(tz), Tp, torch.from_numpy(nf))
    np.testing.assert_array_equal(up_t.numpy(), up)
    pre = jax.vmap(partial(jv.viterbi_precompute_z, frame_sampling=S,
                           max_len=MAX_LEN, l_max=L))
    W_ref, pois_ref, kv_ref = pre(jnp.asarray(lp_z), jnp.asarray(up), jnp.asarray(nf),
                                  jnp.asarray(trs), jnp.asarray(lam))
    W, pois, kv = tv.viterbi_precompute_z(
        torch.from_numpy(lp_z), up_t, torch.from_numpy(nf).long(),
        torch.from_numpy(trs).long(), torch.from_numpy(lam),
        frame_sampling=S, max_len=MAX_LEN, l_max=L,
    )
    np.testing.assert_allclose(W.numpy(), np.asarray(W_ref), **SCORE_TOL)
    # log-Poisson rows cancel f32 terms of magnitude ~1e4 (l * log(lam) vs
    # lgamma(l + 1) at l ~ 2000 frames), whose ulp is ~1e-3: torch's and
    # XLA's lgamma / log may differ by a few of those ulps
    np.testing.assert_allclose(pois.numpy(), np.asarray(pois_ref), rtol=1e-5, atol=4e-3)
    np.testing.assert_array_equal(kv.numpy(), np.asarray(kv_ref))
