"""PyTorch port: the trainable WaveNet stack with its products in
error-compensated TF32, the arithmetic of its tensor-core kernels
(`csrc/wavenet_train.cu`) stated in PyTorch.

`wavenet_stack_train` takes the plain twin on CPU tensors, and that twin
routes every product through `ops/wavenet_stack.py _mm`.  Swapping in
`ops/tf32.py Matmul3xTF32` (forward and both gradient products in 3xTF32),
the forward z and all seven gradients under one cotangent, with the JAX
package's dropout masks, stay within 1e-4 * max|z| and a relative L2 of
1e-3 of the f32 twin and of the JAX kernel `wavenet_stack_train_v3` in
interpret mode, for max and sum pooling, with and without the leaky ReLU,
and with exact ties in a max pool.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.ops.wavenet_train_pallas_v2 import _plan
from mucon_tpu.ops.wavenet_train_pallas_v3 import _make_masks, wavenet_stack_train_v3
from mucon_tpu_torch.ops import wavenet_stack as stack_mod
from mucon_tpu_torch.ops.tf32 import Matmul3xTF32
from mucon_tpu_torch.ops.wavenet_stack_train import wavenet_stack_train
from tests.test_torch_wavenet_train import B, C, LENGTHS, SEED, STAGES, T, _weights

torch.set_num_threads(1)

CASES = pytest.mark.parametrize("pools,pooling_type,leaky,drop,tie", [
    ((1, 2), "max", False, 0.25, False),
    ((1, 2), "max", True, 0.25, False),
    ((1, 3), "sum", False, 0.25, False),  # pool after the last layer
    ((1, 3), "sum", True, 0.0, False),
    ((0, 1), "max", False, 0.0, True),    # exact ties in layer 0's max pool
], ids=["max", "max_leaky", "sum", "sum_leaky_nodrop", "max_ties"])


def _inputs(pools, drop, tie):
    """x, the packed weights, the cotangent (numpy) and the JAX kernel's
    dropout masks, from one seed, as tests/test_torch_wavenet_train.py."""
    rng = np.random.RandomState(0)
    x = np.maximum(rng.randn(B, T, C), 0).astype(np.float32)
    if tie:
        x[:, 1::2] = x[:, 0::2]  # every pair of frames equal
    x *= (np.arange(T)[None, :, None] < LENGTHS[:, None, None])
    weights = _weights(rng, tie)
    t_ins, _, _, t_fin = _plan(STAGES, pools, T)
    g = rng.randn(B, t_fin, C).astype(np.float32)
    masks = _make_masks(jnp.asarray(SEED, jnp.int32), drop, t_ins, B, C)
    return x, weights, g, [torch.from_numpy(np.array(m)) for m in masks] or None


def _port(x, weights, g, masks, pools, pooling_type, leaky):
    """z and the gradients of x and every packed weight under cotangent g."""
    xs = [torch.from_numpy(a).requires_grad_() for a in [x, *weights]]
    z, _ = wavenet_stack_train(xs[0], torch.from_numpy(LENGTHS).long(), *xs[1:], masks,
                               STAGES, pools, pooling_type, leaky)
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


def test_split_matmul_gradients_hold_float64():
    rng = np.random.RandomState(3)
    a64 = torch.from_numpy(rng.randn(2, 9, 16)).requires_grad_()
    b64 = torch.from_numpy(rng.randn(16, 8)).requires_grad_()
    g = rng.randn(2, 9, 8)
    (a64 @ b64).backward(torch.from_numpy(g))
    a, b = (t.detach().float().requires_grad_() for t in (a64, b64))
    out = Matmul3xTF32.apply(a, b)
    out.backward(torch.from_numpy(g).float())
    for got, want in ((out, a64 @ b64), (a.grad, a64.grad), (b.grad, b64.grad)):
        err = (got.double() - want).abs().max().item()
        assert err <= 1e-6 * want.abs().max().item(), err


@CASES
def test_split_train_stack_holds_the_f32_twin(monkeypatch, pools, pooling_type, leaky, drop,
                                              tie):
    x, weights, g, masks = _inputs(pools, drop, tie)
    args = (x, weights, g, masks, pools, pooling_type, leaky)
    z_ref, grads_ref = _port(*args)
    z, grads = _split_port(monkeypatch, *args)
    assert not torch.equal(z, z_ref)  # the products did go through the split
    _held(z, grads, z_ref, grads_ref)
    assert not z[2, LENGTHS[2] >> len(pools):].any()  # the masked tail stays exactly 0


@pytest.mark.interpret
@CASES
def test_split_train_stack_holds_the_jax_kernel(monkeypatch, pools, pooling_type, leaky, drop,
                                                tie):
    x, weights, g, masks = _inputs(pools, drop, tie)
    seed = jnp.asarray(SEED, jnp.int32)

    def f(x, *w):
        return wavenet_stack_train_v3(x, jnp.asarray(LENGTHS), seed, *w, STAGES, pools,
                                      pooling_type, drop, leaky, True, None)

    z_ref, vjp = jax.vjp(f, jnp.asarray(x), *map(jnp.asarray, weights))
    grads_ref = vjp(jnp.asarray(g))
    z, grads = _split_port(monkeypatch, x, weights, g, masks, pools, pooling_type, leaky)
    _held(z, grads, z_ref, grads_ref)
