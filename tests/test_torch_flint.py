"""PyTorch port: the fused flint loss (`ops/mucon_loss.py`) against the JAX
package's `mucon_flint_fused` (`mucon_tpu/ops/mucon_loss_pallas.py`, its
Pallas kernel in interpret mode) on padded batches: values and the
gradients of `MuconFlint` (with its plain forward on the CPU) with respect
to the length logits, the frame logits and the class weights.  Also the
kernel's closed form, written out from `flint_prep`'s vectors, against the
plain twin: what the CUDA kernel computes, checked where it cannot run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.ops.mucon_loss_pallas import mucon_flint_fused
from mucon_tpu_torch.models.masks import TEMPLATE_WIDTH
from mucon_tpu_torch.ops.mucon_loss import (
    MuconFlint,
    flint_prep,
    mucon_flint,
    mucon_flint_plain,
)

torch.set_num_threads(1)

B, N, T, M = 4, 9, 96, 7
N_LEN = np.array([3, 7, 1, 9], np.int32)
T_VALID = np.array([96, 50, 17, 70], np.int32)
TOL = dict(rtol=2e-5, atol=2e-6)
# the length logits place the masks: their gradient sums frame terms of
# order T / L * 100 that cancel (tests/test_torch_losses.py states the same)
TOL_LENGTHS_GRAD = dict(rtol=2e-5, atol=1e-4)
# A frame on a box edge takes the mask value 1 - (c - 99) or c + 1, with the
# pixel coordinate c = (scale * g + xloc + 1) * 99 / 2, where scale * g and
# xloc (of order T_i / L_n) cancel to O(1): in f32 c is uncertain by about
# 99 * ulp(T_i / L_n), 1e-4 of that frame's mask and so of its gradient.
# The last valid frame of every video lies on such an edge (the lengths
# sum to T_i), so each framework rounds a few of these differently.
TOL_SEG_GRAD = dict(rtol=5e-4, atol=2e-6)
# d loss / d w_c sums (nll_n - loss) / sum(w) over the segments of class c:
# differences of values that are held at TOL each
TOL_WEIGHTS_GRAD = dict(rtol=1e-4, atol=2e-6)


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return dict(lr=(1.5 * rng.randn(B, N)).astype(np.float32),
                seg=(2.0 * rng.randn(B, T, M)).astype(np.float32),
                tgt=rng.randint(0, M, (B, N)).astype(np.int32),
                g=rng.randn(B).astype(np.float32))


def _weights(weighted):
    w = np.ones(M, np.float32)
    if weighted:
        w[0] = 0.25
    return w


@pytest.mark.parametrize("overlap", [0.0, 0.25])
@pytest.mark.parametrize("weighted", [False, True])
def test_flint_values_and_gradients_match_jax(weighted, overlap):
    d, w = _data(), _weights(weighted)
    ints = (jnp.asarray(d["tgt"]), jnp.asarray(N_LEN), jnp.asarray(T_VALID))

    def jax_loss(lr, seg, cw):
        v = mucon_flint_fused(lr, seg, *ints, overlap, weighted, True, cw)
        return jnp.sum(v * d["g"]), v

    grads, ref = jax.grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(d["lr"]), jnp.asarray(d["seg"]), jnp.asarray(w))

    tints = [torch.from_numpy(a).long() for a in (d["tgt"], N_LEN, T_VALID)]
    xs = [torch.from_numpy(a).requires_grad_() for a in (d["lr"], d["seg"], w)]
    got = MuconFlint.apply(xs[0], xs[1], *tints, overlap, weighted, xs[2])
    (got * torch.from_numpy(d["g"])).sum().backward()
    routed = mucon_flint(*(torch.from_numpy(a) for a in (d["lr"], d["seg"])), *tints, overlap,
                         torch.from_numpy(w) if weighted else None)
    for v in (got, routed):
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(ref), **TOL)
    for name, x, want, tol in zip(("lengths_raw", "segmentation", "class_weights"), xs, grads,
                                  (TOL_LENGTHS_GRAD, TOL_SEG_GRAD, TOL_WEIGHTS_GRAD)):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), **tol, err_msg=name)
    if not weighted:
        assert torch.all(xs[2].grad == 0)


@pytest.mark.parametrize("overlap", [0.0, 0.25])
def test_kernel_closed_form_from_prep_matches_plain(overlap):
    """The sums kernel F runs (`csrc/mucon_loss.cu`), from the prep vectors:
    box masks in closed form, the window, log-softmax and the weighted NLL."""
    d, w = _data(1), torch.from_numpy(_weights(True))
    lr, seg, tgt = (torch.from_numpy(d[k]) for k in ("lr", "seg", "tgt"))
    n_len, t_valid = torch.from_numpy(N_LEN).long(), torch.from_numpy(T_VALID).long()
    scale, xloc, sdiv = flint_prep(lr, n_len, t_valid, overlap)
    W = float(TEMPLATE_WIDTH)
    t = torch.arange(T, dtype=torch.float32)
    g = -1.0 + 2.0 * t / torch.clamp(t_valid.float() - 1.0, min=1.0)[:, None]  # [B x T]
    c = (scale[:, :, None] * g[:, None, :] + xloc[:, :, None] + 1.0) * 0.5 * (W - 1.0)
    masks = torch.clamp(torch.minimum(c + 1.0, W - c), 0.0, 1.0)
    masks = torch.where((c <= -1.0) | (c >= W), 0.0, masks)
    ok = (torch.arange(N)[None, :, None] < n_len[:, None, None]) & \
        (t[None, None, :] < t_valid[:, None, None])
    window = torch.bmm(torch.where(ok, masks, 0.0), seg) / sdiv[:, :, None]
    lsm = torch.log_softmax(window, dim=2)
    picked = torch.gather(lsm, 2, tgt.long()[..., None])[..., 0]
    wn = w[tgt.long()] * (torch.arange(N)[None, :] < n_len[:, None])
    closed = -(wn * picked).sum(1) / wn.sum(1)
    want = mucon_flint_plain(lr, seg, tgt.long(), n_len, t_valid, overlap, w)
    np.testing.assert_allclose(closed.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_flint_plain_matches_jax_past_shared_memory(weighted):
    """The plain flint (the CPU route of `mucon_flint`) at M = 600 classes
    and N = 31 segments, a window the card's kernel takes in two chunks of
    classes (`cuda.flint_plan`), against the JAX kernel in interpret mode."""
    rng = np.random.RandomState(11)
    b, n, t, m = 2, 31, 80, 600
    lr = (1.5 * rng.randn(b, n)).astype(np.float32)
    seg = (2.0 * rng.randn(b, t, m)).astype(np.float32)
    tgt = rng.randint(0, m, (b, n)).astype(np.int32)
    n_len, t_valid = np.array([31, 12], np.int32), np.array([80, 47], np.int32)
    w = np.ones(m, np.float32)
    if weighted:
        w = (0.5 + rng.rand(m)).astype(np.float32)
    ref = mucon_flint_fused(jnp.asarray(lr), jnp.asarray(seg), jnp.asarray(tgt),
                            jnp.asarray(n_len), jnp.asarray(t_valid), 0.25, weighted, True,
                            jnp.asarray(w))
    got = mucon_flint(torch.from_numpy(lr), torch.from_numpy(seg),
                      *(torch.from_numpy(a).long() for a in (tgt, n_len, t_valid)), 0.25,
                      torch.from_numpy(w) if weighted else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
