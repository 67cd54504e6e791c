"""PyTorch port: the WaveNet eval stack against the JAX block and the Pallas
kernel (interpret mode), and the port's module path against both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.models.temporal import WaveNetBlock as JaxWaveNetBlock
from mucon_tpu.ops.wavenet_pallas_v2 import (
    pack_wavenet_params as jax_pack,
    wavenet_stack_pallas_v2,
)
from mucon_tpu_torch.convert import params_to_state_dict
from mucon_tpu_torch.models.temporal import WaveNetBlock
from mucon_tpu_torch.ops.wavenet_stack import (
    pack_wavenet_params,
    wavenet_stack,
    wavenet_stack_plain,
)

torch.set_num_threads(1)

B, T, DIN, C = 3, 128, 12, 16
STAGES = (1, 2, 4, 8, 64, 256)  # 64 and 256 reach past the pooled T=32
POOLS = (1, 2)
LENGTHS = np.array([128, 97, 50], np.int32)
TOL = dict(rtol=1e-5, atol=1e-5)


def _blocks(pooling_type, leaky):
    jb = JaxWaveNetBlock(in_channels=DIN, stages=STAGES, out_dims=C,
                         pooling_layers=POOLS, pooling_type=pooling_type,
                         leaky=leaky)
    rng = np.random.RandomState(0)
    feats = rng.randn(B, T, DIN).astype(np.float32)
    params = jb.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                     jnp.asarray(LENGTHS), False)["params"]
    tb = WaveNetBlock(DIN, STAGES, C, POOLS, pooling_type, leaky)
    tb.load_state_dict(params_to_state_dict(params), strict=True)
    return jb, params, tb, feats


CASES = pytest.mark.parametrize("pooling_type,leaky", [("max", False), ("sum", True)])


@CASES
def test_block_and_plain_stack_match_jax_block(pooling_type, leaky):
    jb, params, tb, feats = _blocks(pooling_type, leaky)
    z_ref, tz_ref = jb.apply({"params": params}, jnp.asarray(feats),
                             jnp.asarray(LENGTHS), False)
    lengths = torch.as_tensor(LENGTHS, dtype=torch.int64)
    with torch.no_grad():
        z_mod, tz_mod = tb(torch.from_numpy(feats), lengths)
        x = tb.in_projection(torch.from_numpy(feats), lengths)
        z_st, tz_st = wavenet_stack_plain(
            x, lengths, *pack_wavenet_params(tb), stages=STAGES,
            pooling_layers=POOLS, pooling_type=pooling_type, leaky=leaky,
        )
    assert z_mod.shape == (B, T // 4, C)
    for z, tz in ((z_mod, tz_mod), (z_st, tz_st)):
        np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), **TOL)
        np.testing.assert_array_equal(tz.numpy(), np.asarray(tz_ref))


@pytest.mark.interpret
@CASES
def test_plain_stack_matches_pallas_kernel(pooling_type, leaky):
    _, params, tb, feats = _blocks(pooling_type, leaky)
    lengths = torch.as_tensor(LENGTHS, dtype=torch.int64)
    with torch.no_grad():
        x = tb.in_projection(torch.from_numpy(feats), lengths)
        args = (x, lengths, *pack_wavenet_params(tb))
        kw = dict(stages=STAGES, pooling_layers=POOLS,
                  pooling_type=pooling_type, leaky=leaky)
        z_plain, tz_plain = wavenet_stack_plain(*args, **kw)
        z_disp, _ = wavenet_stack(*args, **kw)  # CPU tensor -> plain twin
    z_k, tz_k = wavenet_stack_pallas_v2(
        jnp.asarray(x.numpy()), jnp.asarray(LENGTHS),
        *jax_pack(params, len(STAGES)), interpret=True, **kw,
    )
    np.testing.assert_allclose(z_plain.numpy(), np.asarray(z_k), **TOL)
    np.testing.assert_array_equal(tz_plain.numpy(), np.asarray(tz_k))
    assert torch.equal(z_disp, z_plain)
