"""PyTorch port: the sequence-parallel halo exchange
(`mucon_tpu_torch/parallel/halo.py`) against the JAX package's.

`make_sp_dilated_conv` on 4 gloo ranks (`tests/torch_mesh_worker.py`), each
holding 16 of 64 frames, against JAX `make_sp_dilated_conv(make_mesh(2, 4),
d)` on the 8-virtual-device CPU mesh for d = 1, 3, 8 at rtol = atol = 1e-5
(tests/test_parallel.py:209-232); its backward -- the halo sent the other
way -- against single-process autograd of the unsharded conv: the blocks'
input gradients concatenated, and the ranks' weight and bias gradients
summed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mucon_tpu.parallel.halo import make_sp_dilated_conv as jax_make_sp_dilated_conv
from mucon_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mucon_tpu_torch.parallel.halo import dilated_conv3_sp, halo_shift
from tests.torch_mesh_worker import spawn_ranks

torch.set_num_threads(1)
DILATIONS = (1, 3, 8)


def _shift(x, offset):
    """out[:, t] = x[:, t + offset], zeros past either end."""
    T = x.shape[1]
    padded = F.pad(x, (0, 0, abs(offset), abs(offset)))
    return padded[:, abs(offset) + offset: abs(offset) + offset + T]


@pytest.fixture(scope="module")
def halo_run(tmp_path_factory):
    """One run of the 4 ranks for every dilation: inputs and rank outputs."""
    rng = np.random.RandomState(0)
    B, T, C = 2, 64, 8
    x = rng.randn(B, T, C).astype(np.float32)
    w = (rng.randn(3, C, C) * 0.1).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    dy = rng.randn(B, T, C).astype(np.float32)
    res = spawn_ranks("halo", 4, tmp_path_factory.mktemp("halo"),
                      dict(x=x, w=w, b=b, dy=dy, seq=4, dilations=DILATIONS))
    return (x, w, b, dy), res


@pytest.mark.parametrize("d", DILATIONS)
def test_sp_dilated_conv_matches_jax_and_autograd(halo_run, d):
    (x, w, b, dy), res = halo_run
    y = torch.cat([r[d]["y"] for r in res], dim=1).numpy()
    want = np.asarray(jax_make_sp_dilated_conv(jax_make_mesh(2, 4), d)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)

    xt, wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    ref = _shift(xt, -d) @ wt[0] + xt @ wt[1] + _shift(xt, d) @ wt[2] + bt
    np.testing.assert_allclose(y, ref.detach().numpy(), rtol=1e-5, atol=1e-5)
    ref.backward(torch.from_numpy(dy))
    dx = torch.cat([r[d]["dx"] for r in res], dim=1)
    dw = sum(r[d]["dw"] for r in res)
    db = sum(r[d]["db"] for r in res)
    for name, got, want_g in (("dx", dx, xt.grad), ("dw", dw, wt.grad), ("db", db, bt.grad)):
        np.testing.assert_allclose(got.numpy(), want_g.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_halo_longer_than_the_block_raises():
    """|offset| <= T_local (halo.py:43): the check comes before any
    exchange; a shift of 0 is the block itself."""
    x = torch.zeros(1, 4, 2)
    with pytest.raises(ValueError, match="exceeds the local block of 4"):
        halo_shift(x, 5)
    with pytest.raises(ValueError):
        dilated_conv3_sp(x, torch.zeros(3, 2, 2), torch.zeros(2), dilation=-5)
    assert halo_shift(x, 0) is x
