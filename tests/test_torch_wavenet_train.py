"""PyTorch port: the trainable WaveNet stack against the JAX package's v3
kernel `wavenet_stack_train_v3` (interpret mode): the forward and the
gradients of x and every packed weight under `jax.vjp` with one
cotangent, dropout on.  JAX draws its masks inside the kernel from a seed;
the test rebuilds them with `_make_masks` and hands them to the port,
whose dispatch takes the plain twin on CPU tensors (the function the CUDA
kernels are held against on the card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.ops.wavenet_train_pallas_v2 import _nonlin_fn, _nonlin_grad_from_h, _plan
from mucon_tpu.ops.wavenet_train_pallas_v3 import _make_masks, _pool2_bwd_xla, wavenet_stack_train_v3
from mucon_tpu_torch.models.layers import dropout_mask
from mucon_tpu_torch.models.temporal import nonlinearity, pool2_time
from mucon_tpu_torch.ops.wavenet_stack_train import stack_plan, wavenet_stack_train

torch.set_num_threads(1)
pytestmark = pytest.mark.interpret

B, T, C = 3, 64, 16
STAGES = (1, 2, 4, 8)
LENGTHS = np.array([64, 45, 17], np.int32)
SEED = 7
TOL = dict(rtol=1e-5, atol=2e-5)


def _weights(rng, tie: bool):
    L = len(STAGES)
    w3 = (rng.randn(L, 3, C, C) / np.sqrt(3 * C)).astype(np.float32)
    b3 = (0.1 * rng.randn(L, C)).astype(np.float32)
    w1 = (rng.randn(L, C, C) / np.sqrt(C)).astype(np.float32)
    b1 = (0.1 * rng.randn(L, C)).astype(np.float32)
    if tie:  # layer 0 adds nothing to its input, so its pool sees x itself
        w1[0] = 0.0
        b1[0] = 0.0
    wl = (rng.randn(C, C) / np.sqrt(C)).astype(np.float32)
    bl = (0.1 * rng.randn(C)).astype(np.float32)
    return [w3, b3, w1, b1, wl, bl]


@pytest.mark.parametrize("pools,pooling_type,leaky,drop,tie", [
    ((1, 2), "max", False, 0.25, False),
    ((1, 3), "sum", True, 0.25, False),   # pool after the last layer
    ((0, 1), "max", False, 0.0, True),    # exact ties in layer 0's max pool
])
def test_train_stack_matches_v3_kernel(pools, pooling_type, leaky, drop, tie):
    rng = np.random.RandomState(0)
    x = np.maximum(rng.randn(B, T, C), 0).astype(np.float32)
    if tie:
        x[:, 1::2] = x[:, 0::2]  # every pair of frames equal
    x *= (np.arange(T)[None, :, None] < LENGTHS[:, None, None])
    weights = _weights(rng, tie)
    t_ins, pooled, shifts, t_fin = _plan(STAGES, pools, T)
    g = rng.randn(B, t_fin, C).astype(np.float32)

    seed = jnp.asarray(SEED, jnp.int32)

    def f(x, *w):
        return wavenet_stack_train_v3(x, jnp.asarray(LENGTHS), seed, *w, STAGES, pools,
                                      pooling_type, drop, leaky, True, None)

    z_ref, vjp = jax.vjp(f, jnp.asarray(x), *map(jnp.asarray, weights))
    grads_ref = vjp(jnp.asarray(g))
    masks = [torch.from_numpy(np.array(m)) for m in _make_masks(seed, drop, t_ins, B, C)]
    assert stack_plan(STAGES, pools, T) == (t_ins, pooled, shifts, t_fin)

    xs = [torch.from_numpy(a).requires_grad_() for a in [x, *weights]]
    z, tz = wavenet_stack_train(xs[0], torch.from_numpy(LENGTHS).long(), *xs[1:],
                                masks or None, STAGES, pools, pooling_type, leaky)
    z.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tz.numpy(), LENGTHS >> sum(pooled))
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_ref), **TOL)
    names = ("x", "w3", "b3", "w1", "b1", "w_last", "b_last")
    for name, a, b in zip(names, xs, grads_ref):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **TOL, err_msg=name)


def test_max_pool_tie_routes_to_first_element():
    """A tied pair sends its whole gradient to the first frame, as the JAX
    glue `_pool2_bwd_xla` and torch's max_pool1d do; an odd trailing
    frame gets none."""
    rng = np.random.RandomState(1)
    u = rng.randn(2, 9, 4).astype(np.float32)
    u[:, 1::2][:, :4] = u[:, 0::2][:, :4]  # ties in every pair of video 0 and 1
    u[1, 3] += 1.0  # one pair with a strict max in the second frame
    g = rng.randn(2, 4, 4).astype(np.float32)
    ref = _pool2_bwd_xla(jnp.asarray(g), jnp.asarray(u), 9, jnp.asarray([9, 9]), "max")
    ut = torch.from_numpy(u).requires_grad_()
    pool2_time(ut, "max").backward(torch.from_numpy(g))
    np.testing.assert_array_equal(ut.grad.numpy(), np.asarray(ref))
    assert np.all(ut.grad.numpy()[:, 8] == 0)


def test_dropout_mask_rate_and_scale():
    gen = torch.Generator().manual_seed(0)
    assert dropout_mask(gen, 0.0, (4, 4), "cpu") is None
    m = dropout_mask(gen, 0.25, (64, 64, 16), "cpu")
    assert m.dtype == torch.float32
    assert set(m.unique().tolist()) == {0.0, float(np.float32(1 / 0.75))}
    assert abs(m.mean().item() - 1.0) < 0.02


@pytest.mark.parametrize("leaky", [False, True])
def test_nonlinearity_gradient_at_zero_matches_jax_kernel(leaky):
    """A dropped entry of a ReLU'd input is exactly 0 at the out-projection:
    the gradient there is the JAX kernel's (0, or 0.01 leaky), not 1."""
    v = np.array([-1.0, 0.0, 2.0], np.float32)
    x = torch.from_numpy(v).requires_grad_()
    nonlinearity(x, leaky).sum().backward()
    want = np.asarray(_nonlin_grad_from_h(_nonlin_fn(leaky)(jnp.asarray(v)), leaky))
    np.testing.assert_array_equal(x.grad.numpy(), want)
