"""PyTorch port: the v2 trainable WaveNet stack against the JAX package's
`wavenet_stack_train_v2` (interpret mode): its chunking helpers, and the
forward and the gradients of x and every packed weight under `jax.vjp`
with one cotangent, with dropout off and on (the masks rebuilt with
`_make_masks`, the stream v2 draws from its seed), ReLU and leaky ReLU.
The port's dispatch takes the plain twin on CPU tensors, the function the
CUDA kernels are held against on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.ops.wavenet_train_pallas_v2 import _chunk_bounds, _fwd_chunks, _plan
from mucon_tpu.ops.wavenet_train_pallas_v2 import wavenet_stack_train_v2 as jax_v2
from mucon_tpu.ops.wavenet_train_pallas_v3 import _make_masks
from mucon_tpu_torch.ops.wavenet_stack_train_v2 import (
    chunk_bounds,
    fwd_chunks,
    wavenet_stack_train_v2,
)

torch.set_num_threads(1)
pytestmark = pytest.mark.interpret

B, T, C = 3, 64, 16
STAGES = (1, 2, 4, 8)
LENGTHS = np.array([64, 45, 17], np.int32)
SEED = 11
TOL = dict(rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("L", [1, 2, 4, 11])
def test_chunk_bounds_match_jax(L):
    for n in (1, 2, 3, 4, 11, 20):
        assert chunk_bounds(L, n) == _chunk_bounds(L, n), (L, n)


def test_fwd_chunks_match_jax():
    for drop in (0.0, 0.25):
        for sweep in (1, 3, 5):
            for fwd in (0, 1, 2):
                assert fwd_chunks(drop, sweep, fwd) == _fwd_chunks(drop, sweep, fwd)


def _weights(rng):
    L = len(STAGES)
    return [
        (rng.randn(L, 3, C, C) / np.sqrt(3 * C)).astype(np.float32),
        (0.1 * rng.randn(L, C)).astype(np.float32),
        (rng.randn(L, C, C) / np.sqrt(C)).astype(np.float32),
        (0.1 * rng.randn(L, C)).astype(np.float32),
        (rng.randn(C, C) / np.sqrt(C)).astype(np.float32),
        (0.1 * rng.randn(C)).astype(np.float32),
    ]


@pytest.mark.parametrize("pools,leaky,drop,sweep_chunks", [
    ((1, 2), False, 0.0, 3),
    ((1, 2), False, 0.25, 3),
    ((0, 3), True, 0.25, 2),   # pool after the last layer
    ((0, 1), True, 0.0, 1),
])
def test_v2_stack_matches_jax_v2(pools, leaky, drop, sweep_chunks):
    rng = np.random.RandomState(0)
    x = rng.randn(B, T, C).astype(np.float32)  # unmasked: v2 masks its input
    weights = _weights(rng)
    t_ins, pooled, _, t_fin = _plan(STAGES, pools, T)
    g = rng.randn(B, t_fin, C).astype(np.float32)
    seed = jnp.asarray(SEED, jnp.int32)

    def f(x, *w):
        return jax_v2(x, jnp.asarray(LENGTHS), seed, *w, STAGES, pools, drop, leaky, True,
                      sweep_chunks, 0)

    z_ref, vjp = jax.vjp(f, jnp.asarray(x), *map(jnp.asarray, weights))
    grads_ref = vjp(jnp.asarray(g))
    masks = [torch.from_numpy(np.array(m)) for m in _make_masks(seed, drop, t_ins, B, C)]

    xs = [torch.from_numpy(a).requires_grad_() for a in [x, *weights]]
    z, tz = wavenet_stack_train_v2(xs[0], torch.from_numpy(LENGTHS).long(), *xs[1:],
                                   masks or None, STAGES, pools, leaky,
                                   sweep_chunks=sweep_chunks)
    z.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tz.numpy(), LENGTHS >> sum(pooled))
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_ref), **TOL)
    names = ("x", "w3", "b3", "w1", "b1", "w_last", "b_last")
    for name, a, b in zip(names, xs, grads_ref):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **TOL, err_msg=name)
