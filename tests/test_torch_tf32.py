"""PyTorch port: error-compensated TF32 (`mucon_tpu_torch/ops/tf32.py`), the
arithmetic of the MS-TCN++ stage's tensor-core kernel stated in PyTorch.

`tf32_round` against numpy bit arithmetic; the hi/lo split reproduces x to
2^-21 |x|; the three-product matmul is as accurate as an f32 matmul where
a single TF32 product is not (the reason for the split); and the MS-TCN++
stage's plain twin with its products swapped for the split ones stays
within 1e-5 of the f32 twin and of the JAX kernel in interpret mode, over
11 residual layers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.ops.mstcnpp_pallas import mstcnpp_stack_pallas_sliced
from mucon_tpu.ops.mstcnpp_pallas import pack_mstcnpp_params as jax_pack
from mucon_tpu_torch.models.layers import mask_time
from mucon_tpu_torch.models.temporal import MSTCNPPFirstStage
from mucon_tpu_torch.ops import mstcnpp_stack as stack_mod
from mucon_tpu_torch.ops.mstcnpp_stack import mstcnpp_stack_plain, pack_mstcnpp_params
from mucon_tpu_torch.ops.tf32 import matmul_3xtf32_plain, tf32_round, tf32_split
from tests.test_torch_mstcnpp import LENGTHS, POOLS, L, _proj, stage_setup  # noqa: F401

torch.set_num_threads(1)


def _np_tf32_round(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on the uint32 view: add half of the last kept bit,
    clear the 13 dropped bits (sign-magnitude: ties go away from zero)."""
    bits = x.view(np.uint32)
    out = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    return np.where(np.isfinite(x), out, x)


SPECIALS = np.array(
    [0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
     1 + 2.0 ** -11, -(1 + 2.0 ** -11),  # ties: away from zero
     1 + 2.0 ** -11 - 2.0 ** -23, 1 + 2.0 ** -11 + 2.0 ** -23,  # either side of a tie
     2 - 2.0 ** -23,  # the carry runs into the exponent
     np.finfo(np.float32).max, np.finfo(np.float32).tiny, 1e-42],  # overflow, subnormals
    np.float32)


@pytest.mark.parametrize("kind", ["specials", "random", "wide"])
def test_tf32_round_matches_bit_arithmetic(kind):
    rng = np.random.RandomState(0)
    x = {"specials": SPECIALS,
         "random": rng.randn(4096).astype(np.float32),
         "wide": (rng.randn(4096) * 10.0 ** rng.randint(-30, 30, 4096)).astype(np.float32)}[kind]
    got = tf32_round(torch.from_numpy(x.copy())).numpy()
    want = _np_tf32_round(x)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    finite = np.isfinite(want)
    assert not (got[finite].view(np.uint32) & 0x1FFF).any()  # 10 mantissa bits kept
    if kind == "specials":
        assert got[7] == np.float32(1 + 2.0 ** -10) and got[8] == -np.float32(1 + 2.0 ** -10)
        assert got[9] == 1.0 and got[10] == np.float32(1 + 2.0 ** -10) and got[11] == 2.0
        assert np.signbit(got[1]) and not np.signbit(got[0]) and np.isnan(got[4])
        assert np.isinf(got[12])
    with pytest.raises(ValueError):
        tf32_round(torch.zeros(2, dtype=torch.float64))


def test_split_reproduces_x():
    rng = np.random.RandomState(1)
    x = torch.from_numpy((rng.randn(8192) * 10.0 ** rng.randint(-6, 6, 8192)).astype(np.float32))
    hi, lo = tf32_split(x)
    assert torch.equal(hi, tf32_round(x)) and torch.equal(lo, tf32_round(lo))
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert torch.all(err <= 2.0 ** -21 * x.double().abs())
    hi, lo = tf32_split(torch.tensor([np.inf, -np.inf, 0.0]))
    assert torch.equal(hi, torch.tensor([np.inf, -np.inf, 0.0])) and not lo.any()


def test_three_products_hold_f32_where_one_does_not():
    """K = 384, a conv3 of the stage: the split product within 2x the error
    of an f32 matmul; a single TF32 product at least 100x worse."""
    rng = np.random.RandomState(2)
    a = torch.from_numpy(rng.randn(96, 384).astype(np.float32))
    b = torch.from_numpy((rng.randn(384, 128) / np.sqrt(384)).astype(np.float32))
    exact = a.double() @ b.double()
    err = lambda got: (got.double() - exact).abs().max().item()  # noqa: E731
    e_f32, e_3x = err(a @ b), err(matmul_3xtf32_plain(a, b))
    e_1x = err(tf32_round(a) @ tf32_round(b))
    assert e_3x <= 2 * e_f32, (e_3x, e_f32)
    assert e_1x >= 100 * e_3x, (e_1x, e_3x)


def _stage(num_layers, C, pools, seed):
    g = torch.Generator().manual_seed(seed)
    stage = MSTCNPPFirstStage(8, num_layers, C, C, pools)
    for mod in stage.modules():
        if hasattr(mod, "reset_parameters"):
            mod.reset_parameters(g)
    return stage, g


@pytest.mark.parametrize("products,factor", [("3xtf32", 1e-5), ("tf32", None)])
def test_stage_in_split_tf32_holds_the_f32_twin(monkeypatch, products, factor):
    """11 residual layers (C = 16, T = 64, pools after 1, 2, 4, 8): the
    stage in 3xTF32 within 1e-5 * max of the f32 twin; in single TF32 it
    misses even the kernel's 1e-4 bound, pinned so that nobody drops the
    split."""
    stage, g = _stage(11, 16, (1, 2, 4, 8), 3)
    lengths = torch.tensor([64, 37, 0])
    x = mask_time(torch.randn(3, 64, 16, generator=g) * 0.6, lengths)
    with torch.no_grad():
        args = (x, lengths, *pack_mstcnpp_params(stage))
        want, _ = mstcnpp_stack_plain(*args, pooling_layers=(1, 2, 4, 8))
        swap = matmul_3xtf32_plain if products == "3xtf32" else \
            (lambda a, b: tf32_round(a) @ tf32_round(b))
        monkeypatch.setattr(stack_mod, "_mm", swap)
        got, _ = mstcnpp_stack_plain(*args, pooling_layers=(1, 2, 4, 8))
    err, top = (got - want).abs().max().item(), want.abs().max().item()
    assert not got[2].any()
    if factor is not None:
        assert err <= factor * top, (err, top)
    else:
        assert err > 1e-4 * top, (err, top)


def test_stage_in_split_tf32_holds_the_jax_kernel(monkeypatch, stage_setup):  # noqa: F811
    """The same swap against the Pallas kernel in interpret mode."""
    xs, _, variables, ts = stage_setup
    x = _proj(xs, variables["params"])
    packed = jax_pack(variables["params"], L)
    ref, _ = mstcnpp_stack_pallas_sliced(x, jnp.asarray(LENGTHS), *packed, num_layers=L,
                                         pooling_layers=POOLS, interpret=True)
    monkeypatch.setattr(stack_mod, "_mm", matmul_3xtf32_plain)
    with torch.no_grad():
        got, _ = mstcnpp_stack_plain(torch.from_numpy(np.array(x)),
                                     torch.from_numpy(LENGTHS).long(),
                                     *pack_mstcnpp_params(ts), pooling_layers=POOLS)
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
