"""PyTorch port: the WaveNet eval stack with its products in error-compensated
TF32 (`ops/tf32.py matmul_3xtf32_plain`), the arithmetic of its tensor-core
kernel (`csrc/wavenet_stack.cu`) stated in PyTorch.

`wavenet_stack_plain` routes every product through the module-level `_mm`;
swapping the three-product split in there, the stack (6 layers, dilations
past the pooled length, pools after layers 1 and 2) stays within 1e-4 *
max of the f32 twin and of the Pallas kernel in interpret mode, for max
and sum pooling, with and without the leaky ReLU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.ops.wavenet_pallas_v2 import pack_wavenet_params as jax_pack
from mucon_tpu.ops.wavenet_pallas_v2 import wavenet_stack_pallas_v2
from mucon_tpu_torch.ops import wavenet_stack as stack_mod
from mucon_tpu_torch.ops.tf32 import matmul_3xtf32_plain
from mucon_tpu_torch.ops.wavenet_stack import pack_wavenet_params, wavenet_stack_plain
from tests.test_torch_wavenet import LENGTHS, POOLS, STAGES, _blocks

torch.set_num_threads(1)

CASES = pytest.mark.parametrize("pooling_type,leaky", [("max", False), ("max", True),
                                                       ("sum", False), ("sum", True)])


def _stack_args(pooling_type, leaky):
    _, params, tb, feats = _blocks(pooling_type, leaky)
    lengths = torch.as_tensor(LENGTHS, dtype=torch.int64)
    with torch.no_grad():
        x = tb.in_projection(torch.from_numpy(feats), lengths)
    kw = dict(stages=STAGES, pooling_layers=POOLS, pooling_type=pooling_type, leaky=leaky)
    return params, (x, lengths, *pack_wavenet_params(tb)), kw


def _split_stack(monkeypatch, args, kw):
    monkeypatch.setattr(stack_mod, "_mm", matmul_3xtf32_plain)
    with torch.no_grad():
        return wavenet_stack_plain(*args, **kw)


@CASES
def test_stack_in_split_tf32_holds_the_f32_twin(monkeypatch, pooling_type, leaky):
    _, args, kw = _stack_args(pooling_type, leaky)
    with torch.no_grad():
        want, t_want = wavenet_stack_plain(*args, **kw)
    got, t_got = _split_stack(monkeypatch, args, kw)
    assert torch.equal(t_got, t_want)
    err, top = (got - want).abs().max().item(), want.abs().max().item()
    assert err <= 1e-4 * top, (err, top)
    assert not got[2, t_got[2]:].any()  # the masked tail stays exactly 0


@pytest.mark.interpret
@CASES
def test_stack_in_split_tf32_holds_the_jax_kernel(monkeypatch, pooling_type, leaky):
    params, args, kw = _stack_args(pooling_type, leaky)
    ref, t_ref = wavenet_stack_pallas_v2(
        jnp.asarray(args[0].numpy()), jnp.asarray(LENGTHS), *jax_pack(params, len(STAGES)),
        interpret=True, **kw)
    got, t_got = _split_stack(monkeypatch, args, kw)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(t_got.numpy(), np.asarray(t_ref))
    assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
