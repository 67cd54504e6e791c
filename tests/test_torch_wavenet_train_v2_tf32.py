"""PyTorch port: the v2 trainable WaveNet stack with its products in
error-compensated TF32, the arithmetic of its tensor-core kernels
(`csrc/wavenet_train_v2.cu`, which run the v3 kernels' bodies) stated in
PyTorch.

`wavenet_stack_train_v2` takes the plain twin on CPU tensors, and that twin
routes every product through `ops/wavenet_stack.py _mm`.  Swapping in
`ops/tf32.py Matmul3xTF32` (forward and both gradient products in 3xTF32),
the forward z and all seven gradients under one cotangent, with the JAX
package's dropout masks, stay within 1e-4 * max|z| and a relative L2 of
1e-3 (the bounds of tests/test_torch_wavenet_train_tf32.py) of the JAX
kernel `wavenet_stack_train_v2` in interpret mode and of the f32 twin, for
max pooling with and without the leaky ReLU, with a pool after the last
layer, and with exact ties in layer 0's pool (routed to the first of each
pair, as the v2 sweep routes them by the u it recomputes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.ops.wavenet_train_pallas_v2 import _plan
from mucon_tpu.ops.wavenet_train_pallas_v2 import wavenet_stack_train_v2 as jax_v2
from mucon_tpu.ops.wavenet_train_pallas_v3 import _make_masks
from mucon_tpu_torch.ops import wavenet_stack as stack_mod
from mucon_tpu_torch.ops.tf32 import Matmul3xTF32
from mucon_tpu_torch.ops.wavenet_stack_train_v2 import wavenet_stack_train_v2
from tests.test_torch_wavenet_train_v2 import B, C, LENGTHS, SEED, STAGES, T, _weights

torch.set_num_threads(1)

CASES = pytest.mark.parametrize("pools,leaky,drop,tie", [
    ((1, 2), False, 0.25, False),
    ((0, 3), True, 0.25, False),   # pool after the last layer
    ((0, 1), False, 0.0, True),    # exact ties in layer 0's max pool
], ids=["max", "max_leaky_last_pool", "max_ties"])


def _inputs(pools, drop, tie):
    """x, the packed weights, the cotangent (numpy) and the JAX kernel's
    dropout masks, from one seed."""
    rng = np.random.RandomState(0)
    x = np.maximum(rng.randn(B, T, C), 0).astype(np.float32)
    if tie:
        x[:, 1::2] = x[:, 0::2]  # every pair of frames equal
    weights = _weights(rng)
    if tie:  # layer 0 adds nothing to its input, so its pool sees x itself
        weights[2][0] = 0.0
        weights[3][0] = 0.0
    t_ins, _, _, t_fin = _plan(STAGES, pools, T)
    g = rng.randn(B, t_fin, C).astype(np.float32)
    masks = _make_masks(jnp.asarray(SEED, jnp.int32), drop, t_ins, B, C)
    return x, weights, g, [torch.from_numpy(np.array(m)) for m in masks] or None


def _port(x, weights, g, masks, pools, leaky):
    """z and the gradients of x and every packed weight under cotangent g."""
    xs = [torch.from_numpy(a).requires_grad_() for a in [x, *weights]]
    z, _ = wavenet_stack_train_v2(xs[0], torch.from_numpy(LENGTHS).long(), *xs[1:], masks,
                                  STAGES, pools, leaky)
    z.backward(torch.from_numpy(g))
    return z.detach(), [t.grad for t in xs]


def _split_port(monkeypatch, *args):
    monkeypatch.setattr(stack_mod, "_mm", Matmul3xTF32.apply)
    return _port(*args)


def _held(z, grads, z_ref, grads_ref):
    z_ref = torch.as_tensor(np.array(z_ref))
    assert (z - z_ref).abs().max().item() <= 1e-4 * z_ref.abs().max().item()
    names = ("x", "w3", "b3", "w1", "b1", "w_last", "b_last")
    for name, a, b in zip(names, grads, grads_ref):
        b = torch.as_tensor(np.array(b))
        rel = (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()
        assert rel <= 1e-3, (name, rel)


@pytest.mark.interpret
@CASES
def test_v2_tf32_holds_the_jax_kernel(monkeypatch, pools, leaky, drop, tie):
    x, weights, g, masks = _inputs(pools, drop, tie)
    seed = jnp.asarray(SEED, jnp.int32)

    def f(x, *w):
        return jax_v2(x, jnp.asarray(LENGTHS), seed, *w, STAGES, pools, drop, leaky, True, 3, 0)

    z_ref, vjp = jax.vjp(f, jnp.asarray(x), *map(jnp.asarray, weights))
    grads_ref = vjp(jnp.asarray(g))
    z, grads = _split_port(monkeypatch, x, weights, g, masks, pools, leaky)
    _held(z, grads, z_ref, grads_ref)


@CASES
def test_v2_tf32_holds_the_f32_twin(monkeypatch, pools, leaky, drop, tie):
    x, weights, g, masks = _inputs(pools, drop, tie)
    args = (x, weights, g, masks, pools, leaky)
    z_ref, grads_ref = _port(*args)
    z, grads = _split_port(monkeypatch, *args)
    assert not torch.equal(z, z_ref)  # the products did go through the split
    _held(z, grads, z_ref, grads_ref)
    n_pools = sum(1 for p in pools if p < len(STAGES))
    assert not z[2, LENGTHS[2] >> n_pools:].any()  # the masked tail stays exactly 0
